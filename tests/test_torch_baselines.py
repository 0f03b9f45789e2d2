"""The port's baseline evaluations (``drivers/baselines.py``: HMR, SPIN,
PARE predictions) against the JAX package's, on the cases of JAX's
``tests/test_baselines.py``: two players, two views, 512² proxies, random
seeded predictions, and its joints-only fit settings (3 iterations at lr
0.01, no silhouette, no silhouette metrics).

* ``load_baseline_prediction``: HMR ``.npy`` (axis-angle through
  ``batch_rodrigues``) within 1e-6 of JAX's, SPIN/PARE ``.npz`` exact;
  the port's ``rotmat_to_axis_angle`` writes an HMR file that reads back
  as the rotations it came from;
* ``evaluate_baseline_2d`` with and without ``optimize``,
  ``evaluate_baseline_oneview``, ``evaluate_baseline_cross`` and
  ``multi_view_optimization_multi`` with and without the single-view
  initialisation: metrics and fitted parameters within 1e-5. The
  initialisation's broadcast-view fits are cut from their
  ``config.BROAD_VIEW_ITERS`` to 3 iterations in both packages: over the
  full count fp32 drift moves one pose scalar 2.4e-5;
* ``calc_result`` on a small result tree, equal.

The silhouette fits are held in ``tests/test_torch_baselines_sil.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.drivers import baselines as jbase  # noqa: E402
from soccerplayershapepose_tpu.fit import FitConfig as JFitConfig  # noqa
from soccerplayershapepose_tpu.ops import batch_rodrigues as jrodrigues  # noqa
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch.drivers import baselines as tbase  # noqa
from soccerplayershapepose_torch.fit.engine import FitConfig  # noqa: E402
from soccerplayershapepose_torch.io import formats as tio  # noqa: E402
from soccerplayershapepose_torch.ops import rotmat_to_axis_angle  # noqa
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

N, V = 2, 2
TOL = 1e-5
FAST = dict(iters=3, lr=0.01, use_silhouette=False, silhouette_metrics=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def predictions(rng, n):
    """JAX's test's predictions (its ``_predictions``)."""
    out = []
    for _ in range(n):
        aa = rng.randn(1, 24, 3).astype(np.float32) * 0.2
        out.append({
            "pose_rotmats": np.asarray(jrodrigues(jnp.asarray(aa))),
            "betas": rng.randn(1, 10).astype(np.float32) * 0.3,
            "cam_wp": np.array([[0.9, 0.0, 0.0]], np.float32)})
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    preds = predictions(rng, N)
    sils = np.zeros((N, 512, 512), np.float32)
    j2d = rng.uniform(100, 400, (N, 17, 2)).astype(np.float32)
    sils_v = np.zeros((N, V, 512, 512), np.float32)
    j2d_v = rng.uniform(100, 400, (N, V, 17, 2)).astype(np.float32)
    return preds, sils, j2d, sils_v, j2d_v


@pytest.fixture(scope="module")
def both_assets():
    return jassets.synthesize_assets(), synthesize_assets()


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def close_result(got, want):
    for k in ("body_pose", "global_orient", "betas", "cam_wp",
              "translation"):
        close(getattr(got, k).numpy(), getattr(want, k), k)


def test_load_baseline_formats_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    hmr = str(tmp_path / "p.npy")
    np.save(hmr, np.concatenate([[0.9, 0.01, -0.02], rng.randn(72) * 0.3,
                                 rng.randn(10)]).reshape(1, 85))
    got, want = tbase.load_baseline_prediction(hmr), \
        jbase.load_baseline_prediction(hmr)
    assert got["pose_rotmats"].shape == (1, 24, 3, 3)
    np.testing.assert_allclose(got["pose_rotmats"], want["pose_rotmats"],
                               rtol=0, atol=1e-6)
    for k in ("betas", "cam_wp"):
        np.testing.assert_array_equal(got[k], want[k])
    spin = str(tmp_path / "p.npz")
    np.savez(spin, pred_rotmat=np.tile(np.eye(3), (1, 24, 1, 1)),
             pred_betas=rng.randn(1, 10), pred_camera=rng.randn(1, 3))
    got, want = tbase.load_baseline_prediction(spin), \
        jbase.load_baseline_prediction(spin)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # Zero axis-angle is the identity.
    zero = str(tmp_path / "z.npy")
    np.save(zero, np.concatenate([[0.9, 0, 0], np.zeros(82)]).reshape(1, 85))
    np.testing.assert_allclose(tbase.load_baseline_prediction(zero)[
        "pose_rotmats"][0, 0], np.eye(3), atol=1e-6)


def test_hmr_export_reads_back(tmp_path, case):
    """Rotations → ``rotmat_to_axis_angle`` → an HMR ``.npy`` → the same
    rotations."""
    pred = case[0][0]
    aa = rotmat_to_axis_angle(torch.from_numpy(pred["pose_rotmats"].copy()))
    path = str(tmp_path / "hmr.npy")
    np.save(path, np.concatenate([pred["cam_wp"][0], aa.numpy().reshape(-1),
                                  pred["betas"][0]])[None])
    back = tbase.load_baseline_prediction(path)
    np.testing.assert_allclose(back["pose_rotmats"], pred["pose_rotmats"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(back["betas"], pred["betas"], atol=1e-7)


@pytest.mark.parametrize("optimize", [True, False])
def test_evaluate_baseline_2d_matches_jax(both_assets, case, optimize):
    ja, ta = both_assets
    preds, sils, j2d = case[:3]
    want = jbase.evaluate_baseline_2d(ja, preds, sils, j2d,
                                      fit_cfg=JFitConfig(**FAST),
                                      optimize=optimize)
    got = tbase.evaluate_baseline_2d(ta, preds, sils, j2d,
                                     fit_cfg=FitConfig(**FAST),
                                     optimize=optimize, device="cpu")
    assert set(got) == set(want)
    for k in ("init_iou", "init_err", "opt_iou", "opt_err"):
        close(got[k], want[k], k)
    if optimize:
        assert np.all(got["opt_err"] <= got["init_err"])
        close_result(got["result"], want["result"])
    else:
        np.testing.assert_array_equal(got["init_err"], got["opt_err"])
    one = tbase.evaluate_baseline_oneview(ta, preds, sils, j2d,
                                          fit_cfg=FitConfig(**FAST),
                                          device="cpu")
    close(one["opt_err"], want["opt_err"] if optimize else jbase.
          evaluate_baseline_oneview(ja, preds, sils, j2d,
                                    fit_cfg=JFitConfig(**FAST))["opt_err"],
          "oneview")


def test_evaluate_baseline_cross_matches_jax(both_assets, case):
    ja, ta = both_assets
    preds, _, _, sils_v, j2d_v = case
    want = jbase.evaluate_baseline_cross(ja, preds, sils_v, j2d_v,
                                         fit_view=0, eval_view=1, n_views=V,
                                         fit_cfg=JFitConfig(**FAST))
    got = tbase.evaluate_baseline_cross(ta, preds, sils_v, j2d_v,
                                        fit_view=0, eval_view=1, n_views=V,
                                        fit_cfg=FitConfig(**FAST),
                                        device="cpu")
    assert (got["fit_view"], got["eval_view"]) == (0, 1)
    assert got["joint_err"].shape == (N,)
    close(got["silh_iou"], want["silh_iou"], "silh_iou")
    close(got["joint_err"], want["joint_err"], "joint_err")


@pytest.mark.parametrize("single_view_init", [False, True])
def test_multi_view_optimization_multi_matches_jax(both_assets, case,
                                                   single_view_init,
                                                   monkeypatch):
    ja, ta = both_assets
    monkeypatch.setattr(jbase.cfg, "BROAD_VIEW_ITERS", FAST["iters"])
    monkeypatch.setattr(tbase.cfg, "BROAD_VIEW_ITERS", FAST["iters"])
    preds, _, _, sils_v, j2d_v = case
    want = jbase.multi_view_optimization_multi(
        ja, preds, sils_v, j2d_v, single_view_init=single_view_init,
        fit_cfg=JFitConfig(**FAST), rounds=1, iters_per_phase=2)
    got = tbase.multi_view_optimization_multi(
        ta, preds, sils_v, j2d_v, single_view_init=single_view_init,
        fit_cfg=FitConfig(**FAST), rounds=1, iters_per_phase=2,
        device="cpu")
    assert got["result"].body_pose.shape == (N, 23, 3, 3)
    close(got["silh_iou"], want["silh_iou"], "silh_iou")
    close(got["joint_err"], want["joint_err"], "joint_err")
    for k in ("body_pose", "global_orient", "betas", "cam_wp"):
        close(getattr(got["result"], k).numpy(),
              getattr(want["result"], k), k)


def test_calc_result_matches_jax(tmp_path):
    for player, (iou, err) in (("2", (0.5, 8.0)), ("3", (0.7, 4.0))):
        d = tmp_path / "g1" / "s1" / player
        os.makedirs(d)
        tio.write_metrics(str(d / "metrics.xml"), iou, err)
    got = tbase.calc_result(str(tmp_path))
    assert got == jbase.calc_result(str(tmp_path))
    assert got[2] == 2 and got[0] == pytest.approx(0.6)
