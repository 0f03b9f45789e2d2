"""The port's losses, metrics, optimiser and single-view fit against JAX.

Tolerances: metrics and losses at fp32 rounding (1e-6 relative); one Adam
step vs ``optax.adam`` at 1e-7 absolute (same formula, other rounding); the
3-iteration silhouette fit at 1e-4 absolute on the parameters, a tenth of
one Adam step at lr 1e-3. Vertices differ by a few fp32 ulps between the
frameworks; the σ_px = 0.0026 px² sigmoid of a 32² render turns that into
gradient gaps of ~3e-5 relative, and Adam's second step amplifies them where
consecutive gradients cancel.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from soccerplayershapepose_tpu import config as jcfg  # noqa: E402
from soccerplayershapepose_tpu.fit import (  # noqa: E402
    FitConfig as JFitConfig, FitInit as JFitInit, single_view_fit as jfit)
from soccerplayershapepose_tpu.fit import engine as jengine  # noqa: E402
from soccerplayershapepose_tpu.fit.single_view import (  # noqa: E402
    splice_body_pose as jsplice)
from soccerplayershapepose_tpu.losses import multi_task as jmtl  # noqa: E402
from soccerplayershapepose_tpu.ops import batch_rodrigues as jrod  # noqa: E402
from soccerplayershapepose_tpu.ops import camera as jcam  # noqa: E402
from soccerplayershapepose_tpu.ops import segmentation as jseg  # noqa: E402
from soccerplayershapepose_tpu.render import softras as jsr  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.smpl import model as jmodel  # noqa: E402

from soccerplayershapepose_torch.convert import (  # noqa: E402
    assets_from_numpy, fit_init_from_numpy)
from soccerplayershapepose_torch.fit import (  # noqa: E402
    FitConfig, single_view_fit, splice_body_pose)
from soccerplayershapepose_torch.fit import engine as tengine  # noqa: E402
from soccerplayershapepose_torch.losses import multi_task as tmtl  # noqa: E402
from soccerplayershapepose_torch.ops import segmentation as tseg  # noqa: E402

WH = 64          # proxy size of the small fit scenes
PARAMS = ("body_pose", "global_orient", "betas", "cam_wp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Targets from known SMPL parameters, and a perturbed init (B=2)."""
    ja = jassets.synthesize_assets()
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    rng = np.random.RandomState(0)
    b = 2
    rot = np.array(jrod(jnp.asarray(rng.randn(b, 24, 3).astype(np.float32)
                                    * 0.15)))
    betas = (rng.randn(b, 10) * 0.5).astype(np.float32)
    cam = np.tile([[0.9, 0.0, 0.0]], (b, 1)).astype(np.float32)
    out = jmodel.smpl_forward(ja, jnp.asarray(betas), jnp.asarray(rot[:, 1:]),
                              jnp.asarray(rot[:, :1]))
    j2d = np.array(jcam.undo_keypoint_normalisation(
        jcam.orthographic_project(out.joints, jnp.asarray(cam))[
            :, jnp.asarray(jcfg.SMPL_TO_KPRCNN_MAP)], WH))
    sil = (np.asarray(jsr.render_silhouette(
        out.vertices, jcam.weak_perspective_to_translation(
            jnp.asarray(cam), 5000.0, WH), ja.faces, WH, 5000.0,
        backface_cull=True)) > 0.5).astype(np.float32)
    pert = np.asarray(jrod(jnp.asarray(rng.randn(b, 24, 3).astype(np.float32)
                                       * 0.2)))
    noisy = np.einsum("bjxy,bjyz->bjxz", rot, pert).astype(np.float32)
    init = (noisy[:, 1:], noisy[:, :1], betas + 0.3,
            (cam + np.array([0.05, 0.02, -0.02])).astype(np.float32))
    return ja, ta, init, sil, j2d


def _fits(scene, **kw):
    ja, ta, init, sil, j2d = scene
    jr = jfit(ja, JFitInit(*(jnp.asarray(x) for x in init)), jnp.asarray(sil),
              jnp.asarray(j2d), JFitConfig(proxy_wh=WH, use_pallas=False,
                                           faces_per_chunk=86, **kw))
    tr = single_view_fit(ta, fit_init_from_numpy(*init), sil, j2d,
                         FitConfig(proxy_wh=WH, faces_per_chunk=86, **kw),
                         device="cpu")
    return jax.tree_util.tree_map(np.asarray, jr), tr


def test_splice_body_pose_matches_jax():
    rng = np.random.RandomState(0)
    init = rng.randn(2, 23, 3, 3).astype(np.float32)
    sub = rng.randn(2, 19, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(
        splice_body_pose(torch.from_numpy(sub), torch.from_numpy(init)).numpy(),
        np.asarray(jsplice(jnp.asarray(sub), jnp.asarray(init))))


def test_silhouette_confusion_metrics_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.rand(3, 16, 16).astype(np.float32)
    pred[0, :4] = 0.5                      # round half to even in both
    pred[1, :2] = 1.5
    target = (rng.rand(3, 16, 16) > 0.6).astype(np.float32)
    want = jseg.silhouette_confusion_metrics(jnp.asarray(pred),
                                             jnp.asarray(target))
    got = tseg.silhouette_confusion_metrics(torch.from_numpy(pred),
                                            torch.from_numpy(target))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    # IoU has no epsilon: empty masks give NaN in both
    empty = np.zeros((1, 4, 4), np.float32)
    assert np.isnan(tseg.silhouette_confusion_metrics(
        torch.from_numpy(empty), torch.from_numpy(empty))["iou"].numpy()).all()


@pytest.mark.parametrize("with_vis,scaled,all_tasks",
                         [(False, False, False), (True, True, False),
                          (False, True, True)])
def test_multi_task_loss_matches_jax(with_vis, scaled, all_tasks):
    rng = np.random.RandomState(2)
    losses_on = ("joints2D", "silhouette")
    w = jcfg.FITTING_INIT_LOSS_WEIGHTS
    outputs = {"joints2D": rng.uniform(0, 512, (2, 17, 2)).astype(np.float32),
               "silhouette": rng.rand(2, 8, 8).astype(np.float32)}
    labels = {"joints2D": rng.uniform(0, 512, (2, 17, 2)).astype(np.float32),
              "silhouette": (rng.rand(2, 8, 8) > 0.5).astype(np.float32)}
    if all_tasks:
        losses_on = jmtl.ALL_TASKS
        for d in (outputs, labels):
            d.update(verts=rng.randn(2, 20, 3).astype(np.float32),
                     joints3D=rng.randn(2, 17, 3).astype(np.float32),
                     shape_params=rng.randn(2, 10).astype(np.float32),
                     pose_params_rot_matrices=rng.randn(2, 24, 3, 3).astype(
                         np.float32))
    if with_vis:
        labels["vis"] = rng.rand(2, 17).astype(np.float32)
    scales = {"silhouette": 0.5, "joints2D": 3.0} if scaled else None
    jt, jd = jmtl.multi_task_loss(
        jmtl.init_loss_state(losses_on, w),
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in labels.items()},
        jmtl.MultiTaskLossConfig(losses_on=losses_on), scales)
    tt, td = tmtl.multi_task_loss(
        tmtl.init_loss_state(losses_on, w),
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in labels.items()},
        tmtl.MultiTaskLossConfig(losses_on=losses_on), scales)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.RandomState(3)
    p0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) * s for s in (1e6, 3.0, 1e-3)]
    tx = optax.adam(1e-3)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-7)


def test_evaluate_fit_matches_jax(scene):
    ja, ta, init, sil, j2d = scene
    jcf = JFitConfig(proxy_wh=WH, render_wh=32, use_pallas=False,
                     faces_per_chunk=86)
    tcf = FitConfig(proxy_wh=WH, render_wh=32, faces_per_chunk=86)
    want = jengine.evaluate_fit(ja, *(jnp.asarray(x) for x in init),
                                jnp.asarray(sil), jnp.asarray(j2d), jcf)
    got = tengine.evaluate_fit(ta, *fit_init_from_numpy(*init),
                               torch.from_numpy(sil), torch.from_numpy(j2d),
                               tcf)
    np.testing.assert_allclose(got["pred_j2d"].numpy(),
                               np.asarray(want["pred_j2d"]), atol=1e-4)
    np.testing.assert_array_equal(got["target_sil"].numpy(),
                                  np.asarray(want["target_sil"]))
    # edge pixels of a σ_px = 0.0026 px² render move with ulp-level vertex
    # differences (see the module docstring)
    assert np.abs(got["pred_sil"].detach().numpy()
                  - np.asarray(want["pred_sil"])).max() <= 5e-3
    np.testing.assert_allclose(got["iou"].numpy(), np.asarray(want["iou"]),
                               atol=1e-6)
    np.testing.assert_allclose(got["joint_err"].detach().numpy(),
                               np.asarray(want["joint_err"]), rtol=1e-5)
    np.testing.assert_allclose(got["bce_score"].detach().numpy(),
                               np.asarray(want["bce_score"]), rtol=1e-4)
    fm_j = jengine.fit_metrics(ja, JFitInit(*(jnp.asarray(x) for x in init)),
                               jnp.asarray(sil), jnp.asarray(j2d), jcf)
    fm_t = tengine.fit_metrics(ta, fit_init_from_numpy(*init),
                               torch.from_numpy(sil), torch.from_numpy(j2d),
                               tcf)
    for k in ("silh_iou", "joint_err"):
        np.testing.assert_allclose(fm_t[k].numpy(), np.asarray(fm_j[k]),
                                   rtol=1e-5, err_msg=k)


def test_single_view_fit_with_silhouette_matches_jax(scene):
    jr, tr = _fits(scene, iters=3, render_wh=32)
    np.testing.assert_array_equal(tr.best_iter.numpy(), jr.best_iter)
    assert (jr.best_iter > 1).all()        # the fit moved away from the init
    for k in PARAMS + ("translation",):
        tol = 1e-4 * (200 if k == "translation" else 1)   # t_z ≈ 2f/(wh·s)
        np.testing.assert_allclose(getattr(tr, k).numpy(), getattr(jr, k),
                                   atol=tol, err_msg=k)
    for k in ("silh_iou", "init_silh_iou"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), getattr(jr, k),
                                   atol=1e-6, err_msg=k)
    for k in ("joint_err", "init_joint_err"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), getattr(jr, k),
                                   rtol=1e-5, err_msg=k)
    assert tr.snapshots is None


def test_single_view_fit_priors_and_snapshots_match_jax(scene):
    """Joints-only fit with the relative priors, save_every and snapshots
    (no render: the trajectory is at fp32 rounding)."""
    jr, tr = _fits(scene, iters=3, use_silhouette=False,
                   silhouette_metrics=False, save_every=True,
                   snapshot_every=1, betas_prior=0.01, pose_prior=0.01,
                   rot_ortho_prior=0.01, joints2d_scale=100.0,
                   joint_conf_weighting=True)
    np.testing.assert_array_equal(tr.best_iter.numpy(), jr.best_iter)
    for k in PARAMS:
        np.testing.assert_allclose(getattr(tr, k).numpy(), getattr(jr, k),
                                   atol=1e-6, err_msg=k)
    assert set(tr.snapshots) == set(jr.snapshots)
    for k, v in jr.snapshots.items():
        np.testing.assert_allclose(tr.snapshots[k].numpy(), v,
                                   atol=1e-6 * (200 if k == "translation" else 1),
                                   err_msg=k)


def test_single_view_fit_needs_a_device_where_cuda_is_absent(scene,
                                                             monkeypatch):
    _, ta, init, sil, j2d = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        single_view_fit(ta, fit_init_from_numpy(*init), sil, j2d,
                        FitConfig(iters=1, proxy_wh=WH, render_wh=32))
