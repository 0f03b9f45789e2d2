"""The port's box ops (``ops/nms.py``, ``ops/roi_align.py``) and the
full-frame pipeline's box squaring against the JAX package, on seeded
numpy inputs.

Tolerances:

* ``box_iou``, ``roi_align`` and ``_square_boxes``: ≤ 1e-6 max abs (the
  same fp32 steps in the same order);
* ``nms`` and ``filter_person_detections``: indices and validity exact,
  on scores quantised to a few levels so that most of them tie (the first
  of equal scores wins in both), with scores of −inf and boxes that do
  not overlap at all.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.ops import nms as jnms  # noqa: E402
from soccerplayershapepose_tpu.ops import roi_align as jroi  # noqa: E402
from soccerplayershapepose_tpu.pipeline import fullframe as jff  # noqa: E402

from soccerplayershapepose_torch.ops import nms as tnms  # noqa: E402
from soccerplayershapepose_torch.ops import roi_align as troi  # noqa: E402
from soccerplayershapepose_torch.pipeline import (  # noqa: E402
    fullframe as tff)

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_boxes(rng, n, lo=-20.0, hi=100.0, size=(2.0, 60.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))],
                          -1).astype(np.float32)


def quantised_scores(rng, n, levels=4):
    return (np.round(rng.rand(n) * levels) / levels).astype(np.float32)


def test_box_iou_matches_jax():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 40)
    b = np.concatenate([random_boxes(rng, 30), a[:5],
                        np.array([[5.0, 5.0, 5.0, 9.0]], np.float32)])
    want = np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tnms.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (want == 0).any() and np.allclose(np.diag(want[:5, 30:35]), 1.0)
    # Batched sets: each set against its own.
    a3, b3 = a[:30].reshape(3, 10, 4), b[:30].reshape(3, 10, 4)
    got3 = tnms.box_iou(torch.from_numpy(a3), torch.from_numpy(b3)).numpy()
    for s in range(3):
        np.testing.assert_allclose(got3[s], np.asarray(jnms.box_iou(
            jnp.asarray(a3[s]), jnp.asarray(b3[s]))), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed,iou,levels,max_outputs", [
    (1, 0.5, 4, None), (2, 0.3, 2, None), (3, 0.7, 8, 12), (4, 0.1, 1, 20)])
def test_nms_matches_jax(seed, iou, levels, max_outputs):
    """Four sets at once against JAX's single-set NMS on each: indices and
    validity exact. ``levels=1`` makes nearly every score equal."""
    rng = np.random.RandomState(seed)
    n = 48
    boxes = random_boxes(rng, 4 * n).reshape(4, n, 4)
    scores = quantised_scores(rng, 4 * n, levels).reshape(4, n)
    scores[1, ::5] = -np.inf                    # never kept
    got_i, got_v = tnms.nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), iou, max_outputs)
    k = max_outputs or n
    assert got_i.shape == got_v.shape == (4, k)
    ties = 0
    for s in range(4):
        want_i, want_v = jnms.nms(jnp.asarray(boxes[s]),
                                  jnp.asarray(scores[s]), iou, max_outputs)
        np.testing.assert_array_equal(got_i[s].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v[s].numpy(), np.asarray(want_v))
        kept = scores[s][np.asarray(want_i)[np.asarray(want_v)]]
        ties += len(kept) - len(np.unique(kept))
    assert ties > 0                              # equal scores were kept
    assert not got_v[1].numpy()[np.isinf(scores[1][got_i[1].numpy()])].any()


def test_nms_of_one_set_and_of_nothing_alive():
    """The unbatched (N, 4) form, and a set whose scores are all −inf:
    every slot invalid, index 0."""
    rng = np.random.RandomState(5)
    boxes = random_boxes(rng, 10)
    scores = np.full(10, -np.inf, np.float32)
    i, v = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores))
    assert i.shape == (10,) and not v.any() and not i.any()
    scores = quantised_scores(rng, 10)
    i, v = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 4)
    wi, wv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


@pytest.mark.parametrize("seed,thresh,max_outputs", [
    (6, 0.5, 32), (7, 0.7, 8), (8, 0.0, 64)])
def test_filter_person_detections_matches_jax(seed, thresh, max_outputs):
    rng = np.random.RandomState(seed)
    n = 40
    boxes = random_boxes(rng, n)
    scores = quantised_scores(rng, n, 10)
    labels = rng.randint(0, 3, n).astype(np.int32)
    wb, wv = jnms.filter_person_detections(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        thresh, max_outputs=max_outputs)
    gb, gv = tnms.filter_person_detections(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(labels), thresh, max_outputs=max_outputs)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    assert gv.any() and (gv.numpy().sum() < len(gv))


@pytest.mark.parametrize("output_size,sampling_ratio,aligned,scale", [
    (7, 2, True, 1.0), (16, 1, True, 1.0), (5, 3, False, 0.25),
    (64, 1, True, 1.0)])
def test_roi_align_matches_jax(output_size, sampling_ratio, aligned, scale):
    """Boxes inside, across and outside the map's edge (clamped samples),
    and one degenerate box."""
    rng = np.random.RandomState(9)
    fmap = rng.rand(64, 96, 3).astype(np.float32)
    boxes = np.concatenate([random_boxes(rng, 12, -30.0, 110.0),
                            np.array([[10.0, 10.0, 10.0, 10.0]],
                                     np.float32)]) / scale
    want = np.asarray(jroi.roi_align(
        jnp.asarray(fmap), jnp.asarray(boxes), output_size, scale,
        sampling_ratio, aligned))
    got = troi.roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes),
                         output_size, scale, sampling_ratio, aligned).numpy()
    assert got.shape == (13, output_size, output_size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_roi_align_batch_is_per_frame():
    """The batched form (F, H, W, C) × (F, N, 4) cuts set f from map f,
    bit for bit as one frame at a time."""
    rng = np.random.RandomState(10)
    fmaps = torch.from_numpy(rng.rand(3, 32, 48, 2).astype(np.float32))
    boxes = torch.from_numpy(random_boxes(rng, 12, -10.0, 50.0).reshape(
        3, 4, 4))
    got = troi.roi_align(fmaps, boxes, 8, sampling_ratio=1)
    assert got.shape == (3, 4, 8, 8, 2)
    for f in range(3):
        assert torch.equal(got[f], troi.roi_align(fmaps[f], boxes[f], 8,
                                                  sampling_ratio=1))


def test_square_boxes_matches_jax():
    rng = np.random.RandomState(11)
    boxes = random_boxes(rng, 30, size=(0.0, 80.0)).reshape(2, 15, 4)
    boxes[0, 0] = [5.0, 5.0, 6.0, 5.5]           # below the 8 px floor
    for border in (0.0, 5.0, 40.0):
        want = np.asarray(jff._square_boxes(jnp.asarray(boxes), border))
        got = tff._square_boxes(torch.from_numpy(boxes), border).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    sq = tff._square_boxes(torch.tensor([[10.0, 20.0, 30.0, 80.0]]), 5.0)[0]
    assert float(sq[2] - sq[0]) == float(sq[3] - sq[1]) == 70.0
