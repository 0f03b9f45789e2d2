"""The port's last stand-alone helpers against the JAX package's, and its
profiling helpers on the CPU.

* ``ops/rotations.py``: ``rotmat_to_rot6d`` exact and inverted by
  ``rot6d_to_rotmat``; ``rotmat_to_axis_angle`` within 1e-6 (and inverted
  by ``batch_rodrigues`` away from θ = π, the identity included);
  ``rotate_translate_points`` within 1e-6 with shared and per-batch
  rotations and translations;
* ``ops/camera.py``: ``translation_to_weak_perspective`` (inverting
  ``weak_perspective_to_translation``), ``normalise_keypoints`` (inverting
  ``undo_keypoint_normalisation``) and ``check_joints2d_visibility`` (the
  bounds included) within 1e-6 or equal;
* ``utils/profiling.py``: ``trace`` writes a Chrome trace holding a
  span, which its recorder holds too (tests/test_torch_tracing.py tests
  the recorder).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.ops import camera as jcam  # noqa: E402
from soccerplayershapepose_tpu.ops import rotations as jrot  # noqa: E402

from soccerplayershapepose_torch import ops  # noqa: E402
from soccerplayershapepose_torch.utils import profiling  # noqa: E402

TOL = 1e-6


def rotations(seed, n=64):
    rs = np.random.RandomState(seed)
    aa = rs.randn(n, 3).astype(np.float32)
    aa *= (rs.uniform(0, 3.0, (n, 1)) / np.linalg.norm(aa, axis=-1,
                                                        keepdims=True))
    aa[0] = 0.0
    return aa, np.array(jrot.batch_rodrigues(jnp.asarray(aa)))


def test_rotmat_to_rot6d_matches_jax():
    _, r = rotations(0)
    got = ops.rotmat_to_rot6d(torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrot.rotmat_to_rot6d(r)))
    np.testing.assert_allclose(ops.rot6d_to_rotmat(got).numpy(), r,
                               rtol=0, atol=1e-6)


def test_rotmat_to_axis_angle_matches_jax():
    aa, r = rotations(1)
    got = ops.rotmat_to_axis_angle(torch.from_numpy(r))
    want = np.asarray(jrot.rotmat_to_axis_angle(jnp.asarray(r)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # The log map inverts Rodrigues away from θ = π (identity: zero).
    np.testing.assert_allclose(got.numpy(), aa, rtol=0, atol=2e-3)
    assert np.abs(got[0].numpy()).max() == 0.0


@pytest.mark.parametrize("per_batch", [False, True])
def test_rotate_translate_points_matches_jax(per_batch):
    rs = np.random.RandomState(2)
    pts = rs.randn(3, 50, 3).astype(np.float32)
    _, r = rotations(3, n=3)
    t = rs.randn(3, 3).astype(np.float32)
    if not per_batch:
        r, t = r[0], t[0]
    got = ops.rotate_translate_points(*(torch.from_numpy(x)
                                        for x in (pts, r, t)))
    want = jrot.rotate_translate_points(jnp.asarray(pts), jnp.asarray(r),
                                        jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_camera_helpers_match_jax():
    rs = np.random.RandomState(4)
    cam = np.stack([rs.uniform(0.5, 1.1, 16), rs.uniform(-0.2, 0.2, 16),
                    rs.uniform(-0.2, 0.2, 16)], -1).astype(np.float32)
    tr = ops.weak_perspective_to_translation(torch.from_numpy(cam), 5000.0,
                                             512)
    got = ops.translation_to_weak_perspective(tr, 5000.0, 512)
    want = jcam.translation_to_weak_perspective(jnp.asarray(tr.numpy()),
                                                5000.0, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=0)
    np.testing.assert_allclose(got.numpy(), cam, rtol=1e-5, atol=0)

    kp = rs.uniform(-20, 532, (4, 17, 2)).astype(np.float32)
    kp[0, 0] = (0.0, 512.0)                   # on the bounds: visible
    kp[0, 1] = (-1e-3, 10.0)
    norm = ops.normalise_keypoints(torch.from_numpy(kp), 512)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jcam.normalise_keypoints(jnp.asarray(kp),
                                                          512)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(ops.undo_keypoint_normalisation(
        norm, 512).numpy(), kp, rtol=0, atol=1e-4)
    vis = ops.check_joints2d_visibility(torch.from_numpy(kp), 512)
    np.testing.assert_array_equal(
        vis.numpy(), np.asarray(jcam.check_joints2d_visibility(
            jnp.asarray(kp), 512)))
    assert bool(vis[0, 0]) and not bool(vis[0, 1])


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as rec:
        with profiling.span("port_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert rec.summary()["spans"]["port_span"]["count"] == 1
    assert profiling.span("after") is profiling.span("after.too")
