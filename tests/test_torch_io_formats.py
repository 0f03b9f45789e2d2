"""The port's on-disk formats (``io/formats.py``) and PNG codec
(``pipeline/densepose.py``) against the JAX package's.

Every writer, given the same inputs on both sides, writes byte-equal
files (so the C# annotation GUI and either package read a tree the other
wrote); every reader returns equal arrays of equal dtypes from the same
file. ``walk_player_tree`` and ``calc_metrics`` agree on one tree.
Mirrors tests/test_io_formats.py.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import formats as jio  # noqa: E402
from soccerplayershapepose_tpu.pipeline import densepose as jdp  # noqa: E402

from soccerplayershapepose_torch.io import formats as tio  # noqa: E402
from soccerplayershapepose_torch.pipeline import densepose as tdp  # noqa: E402

RNG = np.random.RandomState(0)
FIT = (RNG.randn(1, 23, 3, 3).astype(np.float32),
       RNG.randn(1, 1, 3, 3).astype(np.float32),
       RNG.randn(1, 10).astype(np.float32),
       RNG.randn(1, 3).astype(np.float32))
PER_VIEW = {"view_1": {"translation": RNG.randn(1, 3).astype(np.float32),
                       "global_orient": RNG.randn(1, 1, 3, 3)},
            "view_2": {"translation": RNG.randn(1, 3),
                       "global_orient": RNG.randn(1, 1, 3, 3).astype(
                           np.float32)}}

# (name, writer's file name, args after the path)
WRITERS = [
    ("write_json_xml", "a.xml", ({"k": [1, 2.5, "x"], "n": None},)),
    ("write_boxes", "boxes.xml", (np.array([[1, 2, 3, 4], [5.5, 6, 7, 8]],
                                           np.float32),)),
    ("write_index", "index.xml", ([3, 1, np.int64(7)],)),
    ("write_joints2d", "view_1_j2d.xml",
     (RNG.uniform(0, 512, (17, 3)).astype(np.float32),)),
    ("write_metrics", "metrics.xml", (np.float32(0.83), 7.2)),
    ("write_png", "rgb.png", (RNG.randint(0, 255, (9, 7, 3), np.uint8),)),
    ("write_png", "gray.png", (RNG.randint(0, 255, (5, 6), np.uint8),)),
    ("write_fit_npz", "view_1.npz", FIT),
    ("write_fit_npz", "view_2.npz", tuple(x.astype(np.float64)
                                          for x in FIT)),
]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,fname,args", WRITERS,
                         ids=[w[1] for w in WRITERS])
def test_writer_bytes_match_jax(tmp_path, name, fname, args):
    jp, tp = str(tmp_path / ("j_" + fname)), str(tmp_path / ("t_" + fname))
    getattr(jio, name)(jp, *args)
    getattr(tio, name)(tp, *args)
    assert _read(tp) == _read(jp)


def test_multiview_npz_bytes_match_jax(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jio.write_multiview_npz(jd, FIT[0], FIT[2], PER_VIEW)
    tio.write_multiview_npz(td, FIT[0], FIT[2], PER_VIEW)
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) == ["data.npz", "view_1.npz",
                                               "view_2.npz"]
    for n in names:
        assert _read(os.path.join(td, n)) == _read(os.path.join(jd, n)), n


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want) and got == want, what


@pytest.mark.parametrize("reader,fname", [
    ("read_json_xml", "a.xml"), ("read_boxes", "boxes.xml"),
    ("read_index", "index.xml"), ("read_joints2d", "view_1_j2d.xml"),
    ("read_metrics", "metrics.xml"), ("read_fit_npz", "view_1.npz"),
    ("read_fit_npz", "view_2.npz")])
def test_reader_matches_jax(tmp_path, reader, fname):
    for name, f, args in WRITERS:
        if f == fname:
            getattr(jio, name)(str(tmp_path / f), *args)
    path = str(tmp_path / fname)
    _assert_same(getattr(tio, reader)(path), getattr(jio, reader)(path),
                 reader)


def test_multiview_and_baseline_readers_match_jax(tmp_path):
    d = str(tmp_path / "player")
    jio.write_multiview_npz(d, FIT[0], FIT[2], PER_VIEW)
    _assert_same(tio.read_multiview_npz(d), jio.read_multiview_npz(d),
                 "multiview")
    hmr = str(tmp_path / "hmr.npy")
    np.save(hmr, np.arange(85.0).reshape(1, 85))
    _assert_same(tio.read_hmr_prediction(hmr), jio.read_hmr_prediction(hmr),
                 "hmr")
    spin = str(tmp_path / "spin.npz")
    np.savez(spin, pred_rotmat=RNG.randn(1, 24, 3, 3).astype(np.float32),
             pred_betas=RNG.randn(1, 10), pred_camera=np.zeros((1, 3)))
    _assert_same(tio.read_spin_prediction(spin),
                 jio.read_spin_prediction(spin), "spin")


def test_walk_tree_and_calc_metrics_match_jax(tmp_path):
    root = str(tmp_path)
    for game, scene, player, err in [("g1", "s1", "1", 5.0),
                                     ("g1", "s1", "2", 12.0),
                                     ("g1", "s2", "3", 10.0),
                                     ("g2", "s3", "4", 9.0)]:
        d = os.path.join(root, game, scene, player)
        os.makedirs(d)
        jio.write_metrics(os.path.join(d, "metrics.xml"), 0.8 - err / 100,
                          err)
        for v in ("view_2.png", "view_1.png", "view_1_j2d.xml"):
            open(os.path.join(d, v), "wb").close()
    os.makedirs(os.path.join(root, "g1", "s1", "5"))      # no metrics.xml
    open(os.path.join(root, "g1", "stray.txt"), "w").close()
    for suffix in (".png", "metrics.xml", ".xml"):
        got = list(tio.walk_player_tree(root, view_suffix=suffix))
        want = list(jio.walk_player_tree(root, view_suffix=suffix))
        assert [tuple(vars(n).values()) for n in got] == \
            [tuple(vars(n).values()) for n in want]
        assert len(got) == 5
    for thresh in (None, 10.0):
        got = tio.calc_metrics(root, score_thresh=thresh)
        assert got == jio.calc_metrics(root, score_thresh=thresh)
        assert got["num_players"] == 4
    assert tio.calc_metrics(root, 10.0)["num_flagged_for_refine"] == 2
    empty = tio.calc_metrics(str(tmp_path / "g2" / "s3" / "4"))
    assert empty["num_players"] == 0 and np.isnan(empty["mean_silh_iou"])


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 2), (6, 5, 3), (6, 5, 4)])
def test_png_codec_matches_jax(shape):
    img = RNG.randint(0, 255, shape, np.uint8)
    data = tdp.encode_png(img)
    assert data == jdp.encode_png(img)
    np.testing.assert_array_equal(tdp.decode_png(data), img)


def test_png_decoder_reads_every_filter_like_jax(tmp_path):
    """PIL writes adaptively filtered scanlines (Sub, Up, Average, Paeth);
    both decoders give PIL's pixels."""
    from PIL import Image
    yy, xx = np.mgrid[0:40, 0:48]
    img = np.stack([(xx * 5) % 256, (yy * 7 + xx) % 256,
                    RNG.randint(0, 255, (40, 48))], -1).astype(np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(img).save(path, optimize=True)
    data = _read(path)
    np.testing.assert_array_equal(tdp.decode_png(data), img)
    np.testing.assert_array_equal(tdp.decode_png(data), jdp.decode_png(data))
    with pytest.raises(ValueError):
        tdp.decode_png(b"GIF89a" + data[6:])
