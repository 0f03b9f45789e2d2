"""The detector's training targets, loss and step
(``models/detector.py:center_targets``, ``detector_loss``,
``train/perception.py:make_detector_train_step``) against the JAX
package's.

* ``center_targets`` and ``detector_loss``: every map and term within 1e-6,
  the off-frame box of JAX's
  ``tests/test_perception.py::test_detector_loss_masks_offframe`` included;
* one detector step from JAX's fresh state, held as
  ``test_torch_perception_train`` holds ProxyNet's (losses within 1e-5
  relative, BN statistics within 1e-5 relative, parameters within 1e-6
  but for Adam's counted sign flips), and a player below the visible fill
  left out of the targets.

Frames of 64 × 96 with seeded boxes, one of them centred off the frame.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa

from soccerplayershapepose_torch.models import detector as tdet  # noqa
from soccerplayershapepose_torch.train import perception as ttrain  # noqa

from test_torch_perception_train import (  # noqa: E402
    CH, LOSS_REL, LR, JitNet, assert_state_agrees, blob_images, jax_batch,
    jit_update, port_state, rel, torch_batch)

DET_HW = (64, 96)
TARGET_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_batch(seed=0, b=2, hw=DET_HW, n=4):
    rs = np.random.RandomState(seed)
    image, _ = blob_images(rs, b, *hw)
    h, w = hw
    x1 = rs.uniform(-10, w - 20, (b, n))
    y1 = rs.uniform(-10, h - 30, (b, n))
    boxes = np.stack([x1, y1, x1 + rs.uniform(8, 30, (b, n)),
                      y1 + rs.uniform(16, 50, (b, n))], -1)
    boxes[0, 0] = [-50, -50, -10, -10]          # centre off the frame
    return {"image": image, "boxes": boxes.astype(np.float32),
            "mask": (rs.rand(b, n) > 0.2).astype(np.float32),
            "visible_fill": rs.uniform(0.02, 0.45, (b, n)).astype(
                np.float32)}




def jax_detector_state(seed=0):
    model = jdet.PlayerDetector(channels=CH)
    state, tx = jtrain.make_detector_state(model, jax.random.PRNGKey(seed),
                                           hw=DET_HW, learning_rate=LR)
    return model, state, tx


# ---------------------------------------------------------------------------
# Detector targets and loss
# ---------------------------------------------------------------------------

def test_center_targets_and_loss_mask_offframe():
    """JAX's off-frame case: the box whose centre lies off the frame is
    masked, and the loss stays finite; both packages agree."""
    boxes = np.asarray([[[10.0, 10.0, 30.0, 30.0],
                         [-50.0, -50.0, -10.0, -10.0]]], np.float32)
    mask = np.ones((1, 2), np.float32)
    want = jdet.center_targets(jnp.asarray(boxes), jnp.asarray(mask),
                               (64, 64))
    got = tdet.center_targets(torch.from_numpy(boxes),
                              torch.from_numpy(mask), (64, 64))
    assert got["mask"].tolist() == [[1.0, 0.0]]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TARGET_TOL, err_msg=k)
    jout = jdet.DetectorOutput(jnp.zeros((1, 16, 16, 1)),
                               jnp.ones((1, 16, 16, 2)),
                               jnp.zeros((1, 16, 16, 2)))
    tout = tdet.DetectorOutput(torch.zeros((1, 16, 16, 1)),
                               torch.ones((1, 16, 16, 2)),
                               torch.zeros((1, 16, 16, 2)))
    jt, jparts = jdet.detector_loss(jout, want, jnp.asarray(mask))
    tt, tparts = tdet.detector_loss(tout, got, torch.from_numpy(mask))
    assert np.isfinite(float(tt))
    assert abs(float(tt) - float(jt)) <= TARGET_TOL * max(1, abs(float(jt)))
    for k in jparts:
        assert abs(float(tparts[k]) - float(jparts[k])) <= TARGET_TOL \
            * max(1.0, abs(float(jparts[k]))), k


@pytest.mark.parametrize("seed", [0, 1])
def test_center_targets_and_detector_loss_match_jax(seed):
    batch = frame_batch(seed, b=3, n=6)
    hw = DET_HW
    want = jdet.center_targets(jnp.asarray(batch["boxes"]),
                               jnp.asarray(batch["mask"]), hw)
    got = tdet.center_targets(torch.from_numpy(batch["boxes"]),
                              torch.from_numpy(batch["mask"]), hw)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TARGET_TOL, err_msg=k)
    rs = np.random.RandomState(seed + 10)
    h, w = hw[0] // 4, hw[1] // 4
    maps = [rs.randn(3, h, w, c).astype(np.float32) for c in (1, 2, 2)]
    maps[1] = np.abs(maps[1]) * 4
    jt, jparts = jdet.detector_loss(jdet.DetectorOutput(
        *(jnp.asarray(m) for m in maps)), want, jnp.asarray(batch["mask"]))
    tt, tparts = tdet.detector_loss(tdet.DetectorOutput(
        *(torch.from_numpy(m) for m in maps)), got,
        torch.from_numpy(batch["mask"]))
    assert rel(tt, jt) <= TARGET_TOL
    for k in jparts:
        assert rel(tparts[k], jparts[k]) <= TARGET_TOL, k


def test_detector_train_step_matches_jax():
    model, jstate, tx = jax_detector_state()
    state = port_state(tdet.PlayerDetector(channels=CH), jstate)
    batch = frame_batch(3)
    jstate, jl = jtrain.make_detector_train_step(
        JitNet(model), jit_update(tx))(jstate, jax_batch(batch))
    state, tl = ttrain.make_detector_train_step()(state, torch_batch(batch))
    assert set(tl) == set(jl) == {"heat", "size", "offset", "total"}
    gaps = {k: rel(tl[k], jl[k]) for k in jl}
    assert max(gaps.values()) <= LOSS_REL, gaps
    assert_state_agrees(state, jstate, LR, "detector step")


def test_detector_step_drops_hidden_players():
    """A player below the visible fill leaves the targets: with every fill
    below 0.08 the size and offset losses are 0."""
    model, jstate, tx = jax_detector_state()
    state = port_state(tdet.PlayerDetector(channels=CH), jstate)
    batch = frame_batch(4)
    batch["visible_fill"][:] = 0.05
    _, tl = ttrain.make_detector_train_step()(state, torch_batch(batch))
    assert float(tl["size"]) == 0.0 and float(tl["offset"]) == 0.0
