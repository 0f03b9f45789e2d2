"""The port's broadcast-view and multi-view fits against JAX
(tests/test_torch_fit_track.py holds the track fit to the same bars).

Small scenes (players with known SMPL parameters, targets at 64², each row
from its own view or frame), the same perturbed init on both sides:

* joints-only fits (``use_silhouette=False``, no render): parameters
  ≤ 1e-5 max abs, the metrics ≤ 1e-5 relative;
* silhouette fits at a 32² render, lr 1e-3: parameters ≤ 1e-4, the
  single-view bar (tests/test_torch_fit.py: a tenth of one Adam step; the
  σ_px = 0.0026 px² sigmoid turns fp32-ulp vertex gaps into gradient gaps
  that Adam amplifies), IoU ≤ 1e-6;
* best-iterate selection is a discrete decision on fp32 metrics: the
  tests assert the same best iterate on both sides where the result
  reports it;
* the alternation: phase A leaves the shared pose and betas bit for bit
  as phase B left them, and phase B the cameras and orients as phase A
  left them.

The helpers below build the scenes of both files: tests/ is on
``sys.path``, and the track file imports them (non-``test_`` names only).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu import config as jcfg  # noqa: E402
from soccerplayershapepose_tpu.fit import broad_view as jbroad  # noqa: E402
from soccerplayershapepose_tpu.fit import multi_view as jmv  # noqa: E402
from soccerplayershapepose_tpu.fit.engine import (  # noqa: E402
    FitConfig as JFitConfig)
from soccerplayershapepose_tpu.ops import batch_rodrigues as jrod  # noqa: E402
from soccerplayershapepose_tpu.ops import camera as jcam  # noqa: E402
from soccerplayershapepose_tpu.render import softras as jsr  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.smpl import model as jmodel  # noqa: E402

from soccerplayershapepose_torch.convert import assets_from_numpy  # noqa: E402
from soccerplayershapepose_torch.fit import (  # noqa: E402
    FitConfig, MultiViewInit, broad_view_fit, multi_view_fit)
from soccerplayershapepose_torch.fit import multi_view as tmv  # noqa: E402

WH = 64          # proxy size of the targets
RENDER = 32      # render size of the silhouette fits
B, V = 2, 2
JOINTS_TOL = 1e-5
SIL_TOL = 1e-4
T_SCALE = 200    # translation t_z ≈ 2f/(wh·s): 200× the camera's scale gap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packages():
    ja = jassets.synthesize_assets()
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    return ja, ta


def random_rotmats(rng, shape, scale):
    return np.asarray(jrod(jnp.asarray(
        rng.randn(*shape, 3).astype(np.float32) * scale)))


def render_targets(ja, rot, betas, cam):
    """(R, wh, wh) silhouettes and (R, 17, 2) joints of R bodies (JAX)."""
    out = jmodel.smpl_forward(ja, jnp.asarray(betas), jnp.asarray(rot[:, 1:]),
                              jnp.asarray(rot[:, :1]))
    j2d = np.array(jcam.undo_keypoint_normalisation(
        jcam.orthographic_project(out.joints, jnp.asarray(cam))[
            :, jnp.asarray(jcfg.SMPL_TO_KPRCNN_MAP)], WH))
    sil = (np.asarray(jsr.render_silhouette(
        out.vertices, jcam.weak_perspective_to_translation(
            jnp.asarray(cam), 5000.0, WH), ja.faces, WH, 5000.0,
        backface_cull=True)) > 0.5).astype(np.float32)
    return sil, j2d


def perturb(rng, rot, scale=0.2):
    pert = random_rotmats(rng, rot.shape[:-2], scale)
    return np.einsum("...xy,...yz->...xz", rot, pert).astype(np.float32)


@pytest.fixture(scope="module")
def views(packages):
    """B players seen in V views: one body pose and betas per player, an
    orient and camera per view; the init perturbs every view's estimate."""
    ja, _ = packages
    rng = np.random.RandomState(10)
    body = random_rotmats(rng, (B, 23), 0.15)
    orient = random_rotmats(rng, (B, V, 1), 0.3)
    orient = np.einsum("bvjxy,yz->bvjxz", orient, np.diag([1.0, -1.0, -1.0])
                       ).astype(np.float32)                # face the camera
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    cam = np.stack([rng.uniform(0.8, 1.0, (B, V)),
                    rng.uniform(-0.1, 0.1, (B, V)),
                    rng.uniform(-0.1, 0.1, (B, V))], -1).astype(np.float32)
    rot = np.concatenate([orient, np.broadcast_to(
        body[:, None], (B, V, 23, 3, 3))], axis=2)           # (B, V, 24, ..)
    sil, j2d = render_targets(ja, rot.reshape(B * V, 24, 3, 3),
                        np.repeat(betas, V, 0), cam.reshape(B * V, 3))
    noisy = perturb(rng, rot)
    init = (noisy[:, :, 1:], noisy[:, :, :1],
            (betas[:, None] + rng.randn(B, V, 10) * 0.3).astype(np.float32),
            (cam + np.array([0.05, 0.02, -0.02])).astype(np.float32))
    return (init, sil.reshape(B, V, WH, WH), j2d.reshape(B, V, 17, 2),
            (body, orient, betas, cam))


def fit_configs(silhouette: bool, **kw):
    common = dict(proxy_wh=WH, faces_per_chunk=86, **kw)
    if silhouette:
        common["render_wh"] = RENDER
    else:
        common.update(use_silhouette=False, silhouette_metrics=False)
    return JFitConfig(use_pallas=False, **common), FitConfig(**common)


def assert_close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def param_tol(silhouette):
    return SIL_TOL if silhouette else JOINTS_TOL


def as_jax(x):
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# Broadcast view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silhouette", [False, True])
def test_broad_view_fit_matches_jax(packages, views, silhouette):
    ja, ta = packages
    init, sil, j2d, (body, _, betas, _) = views
    orient0, cam0 = init[1][:, 0], init[3][:, 0]
    # The joints-only run takes the stage's lr 0.01; the silhouette run the
    # lr 1e-3 at which the single-view bar was set (at 0.01 each Adam step
    # is 10x larger, and so is the gap: 1.46e-4 measured).
    jc, tc = fit_configs(silhouette, iters=3, lr=1e-3 if silhouette else 0.01)
    jr = jbroad.broad_view_fit(ja, as_jax(body), as_jax(betas), as_jax(orient0),
                               as_jax(cam0), as_jax(sil[:, 0]), as_jax(j2d[:, 0]), jc)
    tr = broad_view_fit(ta, body, betas, orient0, cam0, sil[:, 0], j2d[:, 0],
                        tc, device="cpu")
    # Pose and betas stay the fixed inputs, bit for bit.
    np.testing.assert_array_equal(tr.body_pose.numpy(), body)
    np.testing.assert_array_equal(tr.betas.numpy(), betas)
    np.testing.assert_array_equal(tr.best_iter.numpy(),
                                  np.asarray(jr.best_iter))
    assert (np.asarray(jr.best_iter) > 1).all()      # the fit moved
    tol = param_tol(silhouette)
    for k in ("global_orient", "cam_wp"):
        assert_close(getattr(tr, k), getattr(jr, k), tol, k)
    assert_close(tr.translation, jr.translation, tol * T_SCALE, "translation")
    for k in ("silh_iou", "init_silh_iou"):
        assert_close(getattr(tr, k), getattr(jr, k), 1e-6, k)
    for k in ("joint_err", "init_joint_err"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Multi-view
# ---------------------------------------------------------------------------

def _mv_pair(packages, views, silhouette, rounds=1, iters=2, **kw):
    ja, ta = packages
    init, sil, j2d, _ = views
    jc, tc = fit_configs(silhouette, **kw)
    jr = jmv.multi_view_fit(ja, jmv.MultiViewInit(*(as_jax(x) for x in init)),
                            as_jax(sil), as_jax(j2d), jc, rounds=rounds,
                            iters_per_phase=iters)
    tr = multi_view_fit(ta, MultiViewInit(*init), sil, j2d, tc,
                        rounds=rounds, iters_per_phase=iters, device="cpu")
    return jr, tr


@pytest.mark.parametrize("silhouette", [False, True])
def test_multi_view_fit_matches_jax(packages, views, silhouette):
    jr, tr = _mv_pair(packages, views, silhouette)
    tol = param_tol(silhouette)
    shapes = {"body_pose": (B, 23, 3, 3), "betas": (B, 10),
              "global_orient": (B, V, 1, 3, 3), "cam_wp": (B, V, 3),
              "translation": (B, V, 3), "silh_iou": (B,), "joint_err": (B,)}
    for k, shape in shapes.items():
        assert tuple(getattr(tr, k).shape) == shape, k
    for k in ("body_pose", "betas", "global_orient", "cam_wp"):
        assert_close(getattr(tr, k), getattr(jr, k), tol, k)
    assert_close(tr.translation, jr.translation, tol * T_SCALE, "translation")
    np.testing.assert_allclose(tr.joint_err.numpy(), np.asarray(jr.joint_err),
                               rtol=1e-5)
    if silhouette:
        assert_close(tr.silh_iou, jr.silh_iou, 1e-4, "silh_iou")
        assert (tr.silh_iou.numpy() > 0).all()


def test_multi_view_shared_init_is_the_plain_mean(packages, views):
    """Phase A's frozen pose is the mean of the views' rotation matrices,
    off the rotation manifold, as the JAX package keeps it."""
    init, _, _, _ = views
    seen = []
    real = tmv.run_fit_loop

    def spy(assets, trainable, frozen, *a, **k):
        seen.append(frozen)
        return real(assets, trainable, frozen, *a, **k)

    tmv.run_fit_loop = spy
    try:
        tr = multi_view_fit(
            packages[1], MultiViewInit(*init), views[1], views[2],
            fit_configs(False)[1], rounds=1, iters_per_phase=1, device="cpu")
    finally:
        tmv.run_fit_loop = real
    mean = init[0].mean(axis=1)
    np.testing.assert_allclose(seen[0]["pose_init"].numpy(), mean,
                               rtol=0, atol=1e-7)
    dets = np.linalg.det(mean.astype(np.float64))
    assert np.abs(dets - 1.0).max() > 1e-3      # not a rotation
    np.testing.assert_allclose(seen[0]["betas"].numpy(),
                               init[2].mean(axis=1), atol=1e-7)
    assert tr.body_pose.shape == (B, 23, 3, 3)


def test_multi_view_phases_freeze_their_halves(packages, views):
    """Over two rounds: each phase's frozen half is, bit for bit, what the
    other phase returned, and the result is the last phases' output."""
    calls = []
    real = tmv.run_fit_loop

    def spy(assets, trainable, frozen, assemble, *a, **k):
        params, best = real(assets, trainable, frozen, assemble, *a, **k)
        calls.append((assemble, {k: v.clone() for k, v in trainable.items()},
                      dict(frozen), params, k))
        return params, best

    tmv.run_fit_loop = spy
    try:
        _, tr = _mv_pair(packages, views, False, rounds=2, iters=2)
    finally:
        tmv.run_fit_loop = real
    assert [c[0] for c in calls] == [tmv._assemble_mv_a,
                                     tmv._assemble_mv_b] * 2
    for i, (assemble, trainable, frozen, params, kw) in enumerate(calls):
        assert kw["group_size"] == V
        assert kw["mask"].shape == (B * V,)
        if assemble is tmv._assemble_mv_a:
            assert set(params) == {"orient", "cam"}
            if i:
                prev = calls[i - 1][3]                   # phase B's output
                assert torch.equal(frozen["pose_sub"], prev["pose_sub"])
                assert torch.equal(frozen["betas"], prev["betas"])
            # The assembled rows carry the frozen pose and betas unchanged.
            pose, _, betas, _ = assemble(params, frozen)
            assert torch.equal(pose[::V], tmv.splice_body_pose(
                frozen["pose_sub"], frozen["pose_init"]))
            assert torch.equal(betas[::V], frozen["betas"])
            assert not torch.equal(params["cam"], trainable["cam"])
        else:
            assert set(params) == {"pose_sub", "betas"}
            prev = calls[i - 1][3]                       # phase A's output
            assert torch.equal(frozen["orient"], prev["orient"])
            assert torch.equal(frozen["cam"], prev["cam"])
            _, orient, _, cam = assemble(params, frozen)
            assert torch.equal(orient, prev["orient"].reshape(B * V, 1, 3, 3))
            assert torch.equal(cam, prev["cam"].reshape(B * V, 3))
            assert not torch.equal(params["pose_sub"], trainable["pose_sub"])
    last_a, last_b = calls[-2][3], calls[-1][3]
    assert torch.equal(tr.global_orient, last_a["orient"])
    assert torch.equal(tr.cam_wp, last_a["cam"])
    assert torch.equal(tr.betas, last_b["betas"])


