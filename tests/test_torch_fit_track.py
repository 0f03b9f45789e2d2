"""The port's track fit against JAX.

B = 2 players of T = 3 frames (known SMPL parameters, targets at 64²), the
last frame of player 1 padding, the same perturbed init on both sides;
the bars of tests/test_torch_fit_views.py:

* joints-only fit: parameters ≤ 1e-5 max abs, joint error ≤ 1e-5
  relative;
* silhouette fit at a 32² render, lr 1e-3: parameters ≤ 1e-4, IoU ≤ 1e-6;
* the shared betas start at the masked mean over frames and stay one per
  player; new targets in the padded frame change neither the metrics nor
  any real frame's parameters nor the betas, bit for bit.

Each fit runs once per module (``runs``): the port's CPU silhouette fit
of 6 rows takes ~30 s of a single core.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.fit import track as jtrack  # noqa: E402

from soccerplayershapepose_torch.fit import TrackInit, track_fit  # noqa: E402
from soccerplayershapepose_torch.fit import track as ttrack  # noqa: E402

from test_torch_fit_views import (  # noqa: E402,F401 (packages: a fixture)
    WH, B, as_jax, assert_close, fit_configs, packages, param_tol, perturb,
    random_rotmats, render_targets)

T = 3
ITERS = 3
T_SCALE = 200    # translation t_z ≈ 2f/(wh·s): 200× the camera's scale gap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracks(packages):
    """B players of T frames: betas per player, pose, orient and camera per
    frame; the last frame of player 1 is padding."""
    ja, _ = packages
    rng = np.random.RandomState(11)
    rot = random_rotmats(rng, (B, T, 24), 0.15).copy()
    rot[:, :, :1] = np.einsum("btjxy,yz->btjxz", rot[:, :, :1],
                              np.diag([1.0, -1.0, -1.0]))
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    cam = np.stack([rng.uniform(0.8, 1.0, (B, T)),
                    rng.uniform(-0.1, 0.1, (B, T)),
                    rng.uniform(-0.1, 0.1, (B, T))], -1).astype(np.float32)
    sil, j2d = render_targets(ja, rot.reshape(B * T, 24, 3, 3),
                        np.repeat(betas, T, 0), cam.reshape(B * T, 3))
    noisy = perturb(rng, rot)
    init = (noisy[:, :, 1:], noisy[:, :, :1],
            (betas[:, None] + rng.randn(B, T, 10) * 0.3).astype(np.float32),
            (cam + np.array([0.05, 0.02, -0.02])).astype(np.float32))
    mask = np.ones((B, T), np.float32)
    mask[1, -1] = 0.0
    return init, sil.reshape(B, T, WH, WH), j2d.reshape(B, T, 17, 2), mask


@pytest.fixture(scope="module")
def runs(packages, tracks):
    """Each fit once: {(package, silhouette): result}."""
    return {}


def _run(runs, packages, tracks, pkg, silhouette):
    key = (pkg, silhouette)
    if key not in runs:
        ja, ta = packages
        init, sil, j2d, mask = tracks
        jc, tc = fit_configs(silhouette, iters=ITERS)
        if pkg == "jax":
            runs[key] = jtrack.track_fit(
                ja, jtrack.TrackInit(*(as_jax(x) for x in init)),
                as_jax(sil), as_jax(j2d), jc, frame_mask=as_jax(mask))
        else:
            runs[key] = track_fit(ta, TrackInit(*init), sil, j2d, tc,
                                  frame_mask=mask, device="cpu")
    return runs[key]


@pytest.mark.parametrize("silhouette", [False, True])
def test_track_fit_matches_jax(packages, tracks, runs, silhouette):
    jr = _run(runs, packages, tracks, "jax", silhouette)
    tr = _run(runs, packages, tracks, "torch", silhouette)
    tol = param_tol(silhouette)
    shapes = {"body_pose": (B, T, 23, 3, 3), "global_orient": (B, T, 1, 3, 3),
              "betas": (B, 10), "cam_wp": (B, T, 3),
              "translation": (B, T, 3), "silh_iou": (B,), "joint_err": (B,)}
    for k, shape in shapes.items():
        assert tuple(getattr(tr, k).shape) == shape, k
    for k in ("body_pose", "global_orient", "betas", "cam_wp"):
        assert_close(getattr(tr, k), getattr(jr, k), tol, k)
    assert_close(tr.translation, jr.translation, tol * T_SCALE,
                 "translation")
    np.testing.assert_allclose(tr.joint_err.numpy(), np.asarray(jr.joint_err),
                               rtol=1e-5)
    assert_close(tr.silh_iou, jr.silh_iou, 1e-6, "silh_iou")
    # The padded frame is fitted by nothing: it keeps its init.
    init = tracks[0]
    np.testing.assert_array_equal(tr.cam_wp[1, -1].numpy(), init[3][1, -1])


def test_track_shared_init_is_the_masked_mean(packages, tracks):
    init, sil, j2d, mask = tracks
    seen = []
    real = ttrack.run_fit_loop

    def spy(assets, trainable, frozen, assemble, *a, **k):
        seen.append((trainable, k))
        params, best = real(assets, trainable, frozen, assemble, *a, **k)
        seen.append(assemble(params, frozen))
        return params, best

    ttrack.run_fit_loop = spy
    try:
        track_fit(packages[1], TrackInit(*init), sil, j2d,
                  fit_configs(False, iters=2)[1], frame_mask=mask,
                  device="cpu")
    finally:
        ttrack.run_fit_loop = real
    (trainable, kw), rows = seen
    want = (init[2] * mask[..., None]).sum(1) / mask.sum(1, keepdims=True)
    assert_close(trainable["betas"], want, 1e-7, "betas init")
    assert kw["group_size"] == T
    assert torch.equal(kw["metric_weights"], torch.from_numpy(mask.ravel()))
    # One betas per player: every frame's row carries the same one.
    betas = rows[2].reshape(B, T, 10)
    assert torch.equal(betas, betas[:, :1].expand(B, T, 10))


@pytest.mark.parametrize("silhouette", [False, True])
def test_track_padded_frame_moves_nothing(packages, tracks, runs,
                                          silhouette):
    """New targets in the padded frame change neither the metrics nor any
    real frame's parameters nor the betas; without the mask the same
    change moves the metrics."""
    init, sil, j2d, mask = tracks
    ta = packages[1]
    other_sil = sil.copy()
    other_sil[1, -1] = 1.0 - other_sil[1, -1]
    other_j2d = j2d.copy()
    other_j2d[1, -1] += 17.0
    tc = fit_configs(silhouette, iters=ITERS)[1]
    a = _run(runs, packages, tracks, "torch", silhouette)
    b = track_fit(ta, TrackInit(*init), other_sil, other_j2d, tc,
                  frame_mask=mask, device="cpu")
    real = torch.from_numpy(mask > 0)
    for k in ("silh_iou", "joint_err", "betas"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("body_pose", "global_orient", "cam_wp"):
        assert torch.equal(getattr(a, k)[real], getattr(b, k)[real]), k
    if not silhouette:
        c = track_fit(ta, TrackInit(*init), other_sil, other_j2d, tc,
                      device="cpu")
        assert not torch.equal(a.joint_err, c.joint_err)
