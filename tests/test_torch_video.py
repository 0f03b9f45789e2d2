"""The port's video ingestion (``pipeline/video.py``) against the JAX
package's, on the MJPG fixture of tests/test_video.py (40 frames of 48×64,
even frames red, odd frames green): the same frame count and seeded
samples (positions and decoded pixels, resized to the broadcast size),
the same harvested scenes and byte-equal ``broad.png`` files with a colour
gate, with no gate and with each package's frame classifier on the
committed ``weights/frame_classifier.npz``, the accepted-frame cap
honoured, and the same labelling pool from ``sample_for_labeling``."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.pipeline import (  # noqa: E402
    classification as jcls)
from soccerplayershapepose_tpu.pipeline import video as jvideo  # noqa: E402

from soccerplayershapepose_torch.pipeline import (  # noqa: E402
    classification as tcls)
from soccerplayershapepose_torch.pipeline import video as tvideo  # noqa

from test_torch_crop_stages import same_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 40
SIZE_HW = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_video(tmp_path_factory):
    """MJPG AVI: even frames red (class 0), odd frames green (class 1)."""
    path = str(tmp_path_factory.mktemp("vid") / "match_1_HQ.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    assert w.isOpened()
    for i in range(N_FRAMES):
        bgr = (0, 255, 0) if i % 2 else (0, 0, 255)
        w.write(np.full((48, 64, 3), bgr, np.uint8))
    w.release()
    return path


def _is_green(frame_rgb: np.ndarray) -> bool:
    return float(frame_rgb[..., 1].mean()) > float(frame_rgb[..., 0].mean())


def test_frame_count(fixture_video):
    assert (tvideo.video_frame_count(fixture_video)
            == jvideo.video_frame_count(fixture_video) == N_FRAMES)
    with pytest.raises(FileNotFoundError):
        tvideo.video_frame_count(fixture_video + ".missing")


@pytest.mark.parametrize("n,size_hw", [(8, (96, 128)), (12, SIZE_HW),
                                       (60, SIZE_HW)])
def test_sample_video_frames_match_jax(fixture_video, n, size_hw):
    got = list(tvideo.sample_video_frames(fixture_video, n, seed=3,
                                          size_hw=size_hw))
    want = list(jvideo.sample_video_frames(fixture_video, n, seed=3,
                                           size_hw=size_hw))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == n
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == size_hw + (3,) and np.array_equal(g, w)


@pytest.mark.parametrize("gate,n,cap,seed", [
    ("colour", N_FRAMES, 5, 1), ("colour", 10, 200, 2), (None, 10, 3, 0),
    ("classifier", 6, 4, 5)])
def test_harvest_matches_jax(fixture_video, tmp_path, gate, n, cap, seed):
    gates = {"colour": (_is_green, _is_green), None: (None, None)}
    if gate == "classifier":
        weights = os.path.join(REPO, "weights", "frame_classifier.npz")
        gates[gate] = (tcls.load_classifier(weights, "cpu"),
                       jcls.load_classifier(weights))
    tgate, jgate = gates[gate]
    a, b = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = tvideo.harvest_frames_stage(fixture_video, a, classifier=tgate,
                                      n_samples=n, max_accepted=cap,
                                      seed=seed, size_hw=SIZE_HW)
    want = jvideo.harvest_frames_stage(fixture_video, b, classifier=jgate,
                                       n_samples=n, max_accepted=cap,
                                       seed=seed, size_hw=SIZE_HW)
    assert got == want
    assert got["accepted"] <= cap and got["sampled"] <= n
    files = same_tree(a, b)
    assert files == ["match_1_HQ/%s/broad.png" % s for s in got["scenes"]]
    if gate == "colour":
        assert all(int(s) % 2 == 1 for s in got["scenes"])
        odd = sum(p % 2 for p, _ in tvideo.sample_video_frames(
            fixture_video, n, seed=seed, size_hw=SIZE_HW))
        assert got["accepted"] == min(cap, odd)


def test_sample_for_labeling_matches_jax(fixture_video, tmp_path):
    a, b = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = tvideo.sample_for_labeling([fixture_video, fixture_video], a,
                                     per_video=3, seed=0, size_hw=SIZE_HW)
    want = jvideo.sample_for_labeling([fixture_video, fixture_video], b,
                                      per_video=3, seed=0, size_hw=SIZE_HW)
    assert got == want
    assert same_tree(a, b) == got["files"]
