"""The port's scene-tree writer (``train/scenes.py:write_scene_tree``)
against the JAX package's, from the same scene.

The scene (N = 2 players, V = 2 narrow views and the broad one, 64²) is
rendered once by the port, through K3's PyTorch mirror
(``test_torch_extract.fast_rasterize_attributes``), and handed to both
writers, the port's as tensors and JAX's as numpy arrays:

* a clean tree (no corruption), with and without images: the same files,
  byte for byte;
* a corrupted tree: JAX keys each view's corruption by
  ``fold_in(rng, hash((image root, view index)) & 0xFFFF)``; Python salts
  that ``hash`` per process (with 3 of 45 salts tried, no silhouette was
  cut at all), so the test gives JAX's writer a fixed stand-in,
  ``fixed_hash``, and hands the port the draws of JAX's keys
  (``test_torch_fit3d.jax_corruption_draws``, ``drop_p = 0``). The
  silhouettes (``.npy``) and every other file are byte-equal; the joints
  within 1e-4 px (XLA may contract the jitter's multiply-add; one fp32
  ulp at 64 px is 7.6e-6) and the scores within 1e-6;
* the port's own draws (``sample_tree_corruption``) write the same tree
  from the same seed, in any process.

:func:`make_tree` writes the small trees of the stage tests.
"""

import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.train import scenes as jscenes  # noqa: E402

from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import scenes as tscenes  # noqa: E402

from test_torch_extract import fast_rasterize_attributes  # noqa: E402
from test_torch_fit3d import jax_corruption_draws  # noqa: E402

N, V, WH = 2, 2, 64
J2D_TOL = 1e-4
SCORE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render_scene(n_players=N, n_views=V, wh=WH, with_image=False, seed=0):
    """One scene of the port's factory, rendered through K3's mirror."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tscenes, "rasterize_attributes", fast_rasterize_attributes)
    try:
        draws = tscenes.sample_scene_views_draws(
            torch.Generator().manual_seed(seed), n_players, n_views,
            image_wh=wh if with_image else None)
        return tscenes.synth_scene_views(synthesize_assets(), draws, wh=wh)
    finally:
        mp.undo()


def make_tree(root, n_players=N, n_views=V, wh=WH, seed=0,
              first_player_id=2):
    """A corrupted tree (the port's own draws), no images: returns the
    scene."""
    data = render_scene(n_players, n_views, wh, seed=seed)
    tscenes.write_scene_tree(
        str(root), "g1", "s1", data,
        corruption=tscenes.sample_tree_corruption(
            torch.Generator().manual_seed(seed + 1), data),
        write_images=False, first_player_id=first_player_id)
    return data


def as_numpy(data):
    def conv(d):
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in d.items()}
    return {"scene": conv(data["scene"]),
            "views": [conv(v) for v in data["views"]],
            "broad": conv(data["broad"])}


def tree_files(root):
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, f), root)
                for f in files]
    return sorted(out)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def scenes():
    return {False: render_scene(), True: render_scene(with_image=True,
                                                      seed=3)}


@pytest.mark.parametrize("write_images", [False, True])
def test_clean_tree_bytes_match_jax(tmp_path, scenes, write_images):
    data = scenes[write_images]
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jscenes.write_scene_tree(str(jroot), "g1", "s1", as_numpy(data),
                             write_images=write_images)
    tscenes.write_scene_tree(str(troot), "g1", "s1", data,
                             write_images=write_images)
    files = tree_files(jroot)
    assert files == tree_files(troot)
    # 2 players x (2 views + broad) x (image, _sil.npy, _j2d.xml), a gt.npz
    # each, and the scene's three .xml files.
    assert len(files) == N * (V + 1) * 3 + N + 3
    for f in files:
        assert _read(troot / f) == _read(jroot / f), f
    png = _read(troot / "images" / "g1" / "s1" / "2" / "view0.png")
    assert len(png) > (200 if write_images else 0)


def fixed_hash(key) -> int:
    """A stand-in for the salted ``hash`` by which JAX's writer keys each
    view's corruption: the same in every process."""
    return zlib.crc32(repr(key).encode())


def test_corrupted_tree_matches_jax(tmp_path, scenes, monkeypatch):
    data = scenes[False]
    monkeypatch.setattr(jscenes, "hash", fixed_hash, raising=False)
    rng = jax.random.PRNGKey(5)
    draws = [jax_corruption_draws(
        jax.random.fold_in(rng, fixed_hash((img_root, k)) & 0xFFFF), N, WH,
        0.0)
        for img_root, n_views in (("images", V), ("broad_images", 1))
        for k in range(n_views)]
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jscenes.write_scene_tree(str(jroot), "g1", "s1", as_numpy(data),
                             corrupt_rng=rng, write_images=False)
    tscenes.write_scene_tree(str(troot), "g1", "s1", data,
                             corruption=draws, write_images=False)
    files = tree_files(jroot)
    assert files == tree_files(troot)
    n_j2d = 0
    for f in files:
        got, want = troot / f, jroot / f
        if f.endswith("_j2d.xml"):
            g = np.array(json.loads(_read(got)), np.float64)
            w = np.array(json.loads(_read(want)), np.float64)
            np.testing.assert_allclose(g[:, :2], w[:, :2], rtol=0,
                                       atol=J2D_TOL, err_msg=f)
            np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=0,
                                       atol=SCORE_TOL, err_msg=f)
            n_j2d += 1
        else:
            assert _read(got) == _read(want), f
    assert n_j2d == N * (V + 1)
    # The corruption moved the joints and cut the silhouettes.
    clean_root = tmp_path / "c"
    tscenes.write_scene_tree(str(clean_root), "g1", "s1", data,
                             write_images=False)
    stem = os.path.join("proxies", "g1", "s1", "2", "view0")
    assert _read(clean_root / (stem + "_j2d.xml")) != \
        _read(troot / (stem + "_j2d.xml"))
    cut = [not np.array_equal(np.load(clean_root / f), np.load(troot / f))
           for f in files if f.endswith("_sil.npy")]
    assert any(cut)


def test_port_draws_write_the_same_tree_from_the_same_seed(tmp_path, scenes):
    data = scenes[False]
    draws = tscenes.sample_tree_corruption(torch.Generator().manual_seed(7),
                                           data)
    assert len(draws) == V + 1
    for d in draws:
        assert d.jitter.shape == (N, 17, 2) and d.cut_centre.shape == (2, N, 2)
        assert not bool(d.dropped.any())
    again = tscenes.sample_tree_corruption(torch.Generator().manual_seed(7),
                                           data)
    for a, b in zip(draws, again):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for name, d in (("a", draws), ("b", again)):
        tscenes.write_scene_tree(str(tmp_path / name), "g1", "s1", data,
                                 corruption=d, write_images=False)
    files = tree_files(tmp_path / "a")
    assert files == tree_files(tmp_path / "b")
    for f in files:
        assert _read(tmp_path / "a" / f) == _read(tmp_path / "b" / f), f
    with pytest.raises(ValueError, match="corruption"):
        tscenes.write_scene_tree(str(tmp_path / "c"), "g1", "s1", data,
                                 corruption=draws[:1])
