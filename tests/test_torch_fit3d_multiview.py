"""The port's ``train/fit3d.py:evaluate_fit_3d_multiview`` against the JAX
package, on the draws of the JAX key stream: one batch of 2 players × 2
views at wh = 64, one round of 2 + 2 iterations and a 2-iteration
single-view arm, the records' fit knobs at a 32² render; each metric
≤ 1e-3 relative (tests/test_torch_fit3d.py gives the bar and its reasons;
the measured gaps are printed).

One near-tie is counted instead: Adam's first step moves each parameter by
lr·sign(g), and the silhouette term's gradient at this render (σ_px =
0.0026 px², so a few edge pixels carry it) is a sum of large per-pixel
contributions in which fp32-ulp vertex gaps can flip the sign of a small
component. Such an element ends exactly 2·lr·k apart (k steps flipped).
The test captures the single-view arm on both sides: every parameter gap
above 1e-4 (the single-view bar) must be such a flip, they are counted
and printed, and where there is one the arm's metrics are held through
the port's metrics of JAX's fitted parameters instead (the found case:
3 of the 2 × 229 parameters of this batch, two body-pose entries and one
camera offset, 2e-3 apart, moving ``sv_joints2d_l2_px`` by 1.6e-3
relative; every other metric agrees within 4.7e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.fit import single_view as jsv  # noqa: E402
from soccerplayershapepose_tpu.fit.engine import (  # noqa: E402
    FitConfig as JFitConfig)
from soccerplayershapepose_tpu.train import fit3d as jfit3d  # noqa: E402

from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.train import fit3d as tfit3d  # noqa: E402
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402

from test_torch_fit3d import (  # noqa: E402,F401 (fixtures)
    ITERS, KNOBS, WH, assert_metrics_agree, both_assets,
    jax_corruption_draws, models)
from test_torch_scenes import jax_scene_views_draws  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluate_fit_3d_multiview_matches_jax(both_assets, models,
                                               monkeypatch):
    ja, ta = both_assets
    jmodel, variables, tmodel = models
    b, v = 2, 2
    seen = {}
    j_fit, t_fit, t_metrics = (jsv.single_view_fit, tfit3d.single_view_fit,
                               tfit3d.metrics_float)

    def j_spy(*a, **k):
        seen["jax"] = (a, j_fit(*a, **k))
        return seen["jax"][1]

    def t_spy(*a, **k):
        seen["torch"] = (a, t_fit(*a, **k))
        return seen["torch"][1]

    def t_metrics_spy(assets, cam, rot, betas, *gt):
        if cam.shape[0] == b:                 # the single-view arm's call
            seen["sv_gt"] = gt
        return t_metrics(assets, cam, rot, betas, *gt)

    monkeypatch.setattr(jsv, "single_view_fit", j_spy)
    monkeypatch.setattr(tfit3d, "single_view_fit", t_spy)
    monkeypatch.setattr(tfit3d, "metrics_float", t_metrics_spy)
    want = jfit3d.evaluate_fit_3d_multiview(
        jmodel, variables["params"], variables["batch_stats"], ja,
        n_batches=1, batch=b, n_views=v, wh=WH,
        fit_cfg=JFitConfig(use_pallas=False, **KNOBS), rounds=1,
        iters_per_phase=ITERS)
    rng = jax.random.fold_in(jax.random.PRNGKey(30_000_000), 0)
    draws = [tfit3d.MultiViewEvalDraws(
        jax_scene_views_draws(rng, b, v, broad=False),
        jax_corruption_draws(jax.random.fold_in(rng, 7), b * v, WH, 0.0))]
    got = tfit3d.evaluate_fit_3d_multiview(
        tmodel, ta, wh=WH, fit_cfg=FitConfig(**KNOBS), rounds=1,
        iters_per_phase=ITERS, draws=draws, device="cpu")
    assert (got["n_players"], got["n_views"], got["rounds"]) == (b, v, 1)
    (_, j_init, *_), j_sv = seen["jax"]
    (_, t_init, _, _, _), t_sv = seen["torch"]
    np.testing.assert_array_equal(t_sv.best_iter.numpy(),
                                  np.asarray(j_sv.best_iter))
    lr, flips = KNOBS["lr"], 0
    for f in ("body_pose", "global_orient", "betas", "cam_wp"):
        gap = np.abs(getattr(t_sv, f).numpy() - np.asarray(getattr(j_sv, f)))
        far = gap[gap > 1e-4]
        steps = np.round(far / (2 * lr))
        assert ((steps >= 1) & (np.abs(far - 2 * lr * steps) <= 1e-5)).all(), \
            (f, far)
        flips += far.size
    print("single-view arm: %d Adam sign flips" % flips)
    assert flips <= 0.01 * sum(np.asarray(x).size for x in j_sv[:4])
    if flips:
        # The arm's metrics from JAX's own fitted parameters.
        gt_pose, gt_betas, gt_j2d = seen["sv_gt"]
        m = tstraps.metrics_float(
            ta, torch.from_numpy(np.array(j_sv.cam_wp)),
            torch.cat([torch.from_numpy(np.array(j_sv.global_orient)),
                       torch.from_numpy(np.array(j_sv.body_pose))], dim=1),
            torch.from_numpy(np.array(j_sv.betas)), gt_pose, gt_betas,
            gt_j2d)
        got.update({"sv_" + k: x for k, x in m.items()})
    assert_metrics_agree(got, want, "evaluate_fit_3d_multiview")
