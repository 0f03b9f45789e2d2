"""The port's detection stages (``pipeline/extract.py``: ``crop_player_stage``,
``crop_broad_player_stage``, ``crop_broad_player_images_stage``,
``detect_players_stage``) against the JAX package's.

With the oracle and the empty runners of tests/test_extract.py (two fixed
boxes per frame, or none) both packages return equal dicts and write
byte-equal trees: the same file list, the same bytes of every PNG and
``boxes.xml``. The trees hold several players and views (player ``'1'``
skipped, ``check_board`` honoured, the ``*_rect.png`` overlays), a scene
with one ``broad.png`` and one with two frames (``<stem>_boxes.xml`` and
the frame-stem level of the crops), and an ``index.xml``.

With the committed ``weights/detector_256x448_f16.npz`` on both sides
(the runner at 64×96 and at 128×192 over frames twice its size, from the
frame synthesis through K3's mirror; the weights score every box far
below 0.7 at these sizes, so ``score_thresh`` is lowered until some
pass): the boxes written agree within 1e-3 px (the detector test's
runner bar), a box kept by one package only where its score lies within
1e-3 (relative) of the threshold, and every crop whose box rounds to the
same integers on both sides is byte-equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.pipeline import (  # noqa: E402
    extract as jextract)

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.io import formats as io  # noqa: E402
from soccerplayershapepose_torch.pipeline import (  # noqa: E402
    extract as textract)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import (  # noqa: E402
    fast_rasterize_attributes, nest_flat)
from test_torch_scene_tree import tree_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "detector_256x448_f16.npz")
BOX_TOL = 1e-3
NEAR_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OracleRunner:
    hw = (64, 64)

    def __call__(self, frames):
        return [np.array([[8.0, 8.0, 24.0, 40.0],
                          [40.0, 20.0, 56.0, 52.0]])] * len(frames)


class EmptyRunner:
    hw = (64, 64)

    def __call__(self, frames):
        return [np.zeros((0, 4))] * len(frames)


def write_views(root, players=("1", "2", "3"), views=("view_1.png",
                                                      "view_2.png"),
                wh=128, seed=0):
    rng = np.random.RandomState(seed)
    for p in players:
        d = os.path.join(root, "g1", "s1", p)
        os.makedirs(d, exist_ok=True)
        for v in views:
            io.write_png(os.path.join(d, v),
                         rng.randint(0, 255, (wh, wh, 3), np.uint8))


def write_frames(root, frames):
    """Scene s1: one ``broad.png``; s2: ``broad.png`` and ``frame2.png``
    (taken from ``frames`` in turn)."""
    layout = {"s1": ["broad.png"], "s2": ["broad.png", "frame2.png"]}
    k = 0
    for scene, names in layout.items():
        d = os.path.join(root, "g1", scene)
        os.makedirs(d, exist_ok=True)
        for name in names:
            io.write_png(os.path.join(d, name), frames[k % len(frames)])
            k += 1


def same_tree(a, b):
    """The trees under ``a`` and ``b`` hold the same files with the same
    bytes; returns the file list."""
    files = tree_files(a)
    assert files == tree_files(b)
    for f in files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f
    return files


def both(tmp_path, name, fn):
    """``fn(module, root)`` on each package's own root: (port's result,
    JAX's result, port root, JAX root)."""
    roots = [str(tmp_path / name / side) for side in ("torch", "jax")]
    got = fn(textract, roots[0])
    want = fn(jextract, roots[1])
    return got, want, roots[0], roots[1]


@pytest.mark.parametrize("runner", [OracleRunner, EmptyRunner])
@pytest.mark.parametrize("variant", ["plain", "save_mid", "keep_one",
                                     "check_board"])
def test_crop_player_stage_matches_jax(tmp_path, runner, variant):
    image_root = str(tmp_path / "views")
    write_views(image_root)
    broad = str(tmp_path / "broad")
    os.makedirs(os.path.join(broad, "g1", "s1", "2"))
    kw = {"plain": {}, "save_mid": {"save_mid": True, "batch_size": 3},
          "keep_one": {"skip_player_one": False, "batch_size": 4},
          "check_board": {"skip_if_present_root": broad}}[variant]
    got, want, a, b = both(tmp_path, "out", lambda m, out: m.crop_player_stage(
        runner(), image_root, out, **kw))
    assert got == want
    files = same_tree(a, b)
    if runner is OracleRunner:
        assert len(files) == got["written"] * (2 if variant == "save_mid"
                                               else 1) > 0
    else:
        assert files == [] and got["written"] == 0 and got["missed"]


@pytest.mark.parametrize("runner", [OracleRunner, EmptyRunner])
def test_crop_broad_player_stages_match_jax(tmp_path, runner):
    rng = np.random.RandomState(1)
    frame_root = str(tmp_path / "frames")
    write_frames(frame_root, [rng.randint(0, 255, (96, 128, 3), np.uint8)
                              for _ in range(3)])

    def run(m, root):
        box_root, vis_root = root + "/boxes", root + "/vis"
        out = m.crop_broad_player_stage(runner(), frame_root, box_root,
                                        vis_root, batch_size=2)
        os.makedirs(os.path.join(box_root, "g1", "s2"), exist_ok=True)
        io.write_index(os.path.join(box_root, "g1", "s2", "index.xml"),
                       [7, 4])
        out["images"] = m.crop_broad_player_images_stage(
            box_root, frame_root, root + "/players")
        return out

    got, want, a, b = both(tmp_path, "broad", run)
    assert got == want
    files = same_tree(a, b)
    assert got["frames"] == 3 and "boxes/g1/s2/frame2_boxes.xml" in files
    if runner is OracleRunner:
        assert got["boxes"] == 6 and got["images"]["crops"] == 4
        assert "players/g1/s2/7/player.png" in files


@pytest.mark.parametrize("runner", [OracleRunner, EmptyRunner])
@pytest.mark.parametrize("broadcast", [True, False])
def test_detect_players_stage_matches_jax(tmp_path, runner, broadcast):
    rng = np.random.RandomState(2)
    frame_root = str(tmp_path / "frames")
    write_frames(frame_root, [rng.randint(0, 255, (80, 112, 3), np.uint8)
                              for _ in range(3)])
    got, want, a, b = both(tmp_path, "det", lambda m, out:
                           m.detect_players_stage(runner(), frame_root, out,
                                                  batch_size=2,
                                                  broadcast=broadcast))
    assert got == want
    files = same_tree(a, b)
    if runner is OracleRunner:
        crops = [f for f in files if f.endswith(".png")]
        assert len(crops) == (6 if broadcast else 3)
        assert any(f.startswith("g1/s2/frame2/") for f in crops) == broadcast


def synth_frames(b=2, hw=(256, 384), n_players=6, seed=7):
    """``b`` synthetic frames of ``n_players``, rendered through K3's
    PyTorch mirror, as uint8."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    try:
        data = tsynth.synth_frame_batch(
            synthesize_assets(), torch.Generator().manual_seed(seed), b=b,
            n_players=n_players, hw=hw)
    finally:
        mp.undo()
    return (data["image"].numpy() * 255.0).astype(np.uint8)


@pytest.fixture(scope="module")
def det_frames():
    """Two 256×384 synthetic frames of 6 players."""
    return synth_frames()


@pytest.fixture(scope="module")
def jax_variables():
    with np.load(WEIGHTS) as z:
        return nest_flat({k: z[k] for k in z.files})


@pytest.mark.parametrize("hw,thresh", [((64, 96), 1e-12),
                                       ((128, 192), 1e-3)])
def test_stages_with_committed_detector(tmp_path, det_frames, jax_variables,
                                        hw, thresh):
    frames = [f[::256 // (2 * hw[0])][:, ::384 // (2 * hw[1])]
              for f in det_frames]       # twice the runner's size
    frame_root = str(tmp_path / "frames")
    write_frames(frame_root, frames)
    runner = textract.PlayerDetectorRunner(
        convert.load_detector_weights(WEIGHTS, "cpu"), hw,
        score_thresh=thresh, device="cpu")
    jrunner = jextract.PlayerDetectorRunner(jdet.PlayerDetector(),
                                            jax_variables, hw,
                                            score_thresh=thresh)
    small = np.stack([textract._resize_frame(f, hw) for f in frames])
    scores = runner.forward(small).scores.numpy()
    near = int((np.abs(scores - thresh) <= NEAR_REL * thresh).sum())

    def run(m, root):
        r = runner if m is textract else jrunner
        out = m.crop_broad_player_stage(r, frame_root, root + "/boxes",
                                        batch_size=2)
        out["images"] = m.crop_broad_player_images_stage(
            root + "/boxes", frame_root, root + "/players")
        out["detect"] = m.detect_players_stage(r, frame_root,
                                               root + "/det", batch_size=2)
        return out

    got, want, a, b = both(tmp_path, "real", run)
    assert got["boxes"] > 0
    assert abs(got["boxes"] - want["boxes"]) <= near
    files = tree_files(a)
    assert [f for f in files if f.endswith(".xml")] == [
        f for f in tree_files(b) if f.endswith(".xml")]
    equal_crops = 0
    for f in files:
        if not f.endswith(".xml"):
            continue
        g, w = io.read_boxes(os.path.join(a, f)), io.read_boxes(
            os.path.join(b, f))
        if len(g) != len(w):
            assert abs(len(g) - len(w)) <= near, f
            continue
        assert np.abs(g - w).max(initial=0.0) <= BOX_TOL, f
        # The crops of each box that rounds alike on both sides.
        scene = os.path.dirname(f)
        top, rest = scene.split("/", 1)
        stem = os.path.basename(f)[:-len("boxes.xml")].rstrip("_")
        for i in np.nonzero((np.round(g) == np.round(w)).all(1))[0]:
            if top == "boxes" and not stem:
                crop = os.path.join("players", rest, str(i + 2))
            elif top == "det":
                crop = os.path.join("det", rest, stem or "broad")
                if not os.path.isdir(os.path.join(a, crop)):
                    crop = os.path.join("det", rest)     # a 1-frame scene
                crop = os.path.join(crop, str(i + 1))
            else:
                continue
            crop = os.path.join(crop, "player.png")
            with open(os.path.join(a, crop), "rb") as x, \
                    open(os.path.join(b, crop), "rb") as y:
                assert x.read() == y.read(), crop
            equal_crops += 1
    assert equal_crops > 0
