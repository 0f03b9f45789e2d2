"""The port's GT-3D fit benchmark of the single-view fit
(``train/straps.py:evaluate_fit_3d``) against the JAX package, on the
draws of the JAX key stream; tests/test_torch_fit3d_multiview.py and
tests/test_torch_fit3d_track.py hold ``train/fit3d.py``'s two to the same
bar, with the helpers defined here.

Each runs one batch at wh = 64 (2 crops here) with the
committed regressor and the records' fit knobs (``weights/fit3d_r05/*.json``
``fit_knobs``: confidence weighting, relative betas and orthogonality
priors, joints2D × 1e6) for 2 iterations at a 32² render, on both sides
from the same draws (the corruption's with ``drop_p=0.0``). Each metric
≤ 1e-3 relative, the ``evaluate_regressor`` bar (the measured gaps are
printed): SMPL vertices differ by fp32 ulps between the frameworks, which
moves silhouette edge pixels and, through the fit, the parameters by
≤ 1e-4 (tests/test_torch_fit.py).

The fit targets' corruption from ``drop_p=0.0`` draws: no joint dropped,
and jitter, scores and cut-outs equal to JAX's ``corrupt_proxy_inputs(...,
drop_p=0.0)``; the port's sampler draws the same stream with either rate.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.fit.engine import (  # noqa: E402
    FitConfig as JFitConfig)
from soccerplayershapepose_tpu.models import regressor as jreg  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402

from test_torch_synth_eval import (  # noqa: E402
    _nest, jax_crop_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
WH, RENDER, ITERS = 64, 32, 2
EVAL_REL = 1e-3
# weights/fit3d_r05/*.json "fit_knobs" (scripts/train_perception.py
# _fit3d_cfg), at this test's size.
KNOBS = dict(iters=ITERS, proxy_wh=WH, render_wh=RENDER, lr=1e-3,
             joint_conf_weighting=True, betas_prior=0.01, pose_prior=0.0,
             rot_ortho_prior=0.05, silh_warmup_iters=0, joints2d_scale=1e6,
             faces_per_chunk=86)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_corruption_draws(rng, b, wh, drop_p):
    """The draws of ``jstraps.corrupt_proxy_inputs(rng, sil (b, wh, wh),
    joints, drop_p=drop_p, return_scores=True)``."""
    k_jit, k_drop, k_cut, k_score = jax.random.split(rng, 4)
    cuts = [jax.random.split(jax.random.fold_in(k_cut, c), 3)
            for c in range(2)]
    u = jax.random.uniform
    return tstraps.CorruptionDraws(
        jitter=_t(jax.random.normal(k_jit, (b, 17, 2))),
        dropped=_t(jax.random.bernoulli(k_drop, drop_p, (b, 17))),
        score_noise=_t(jax.random.normal(k_score, (b, 17))),
        cut_active=_t(np.stack([np.asarray(jax.random.bernoulli(
            k1, 0.5, (b, 1, 1)))[:, 0, 0] for k1, _, _ in cuts])),
        cut_centre=_t(np.stack([u(k2, (b, 2), minval=0.0, maxval=wh)
                                for _, k2, _ in cuts])),
        cut_half=_t(np.stack([u(k3, (b, 2), minval=0.03 * wh,
                                maxval=0.5 * 0.35 * wh)
                              for _, _, k3 in cuts])))


@pytest.fixture(scope="module")
def models():
    with np.load(WEIGHTS) as z:
        variables = _nest({k: z[k] for k in z.files})
    return (jreg.SingleInputRegressor(in_channels=18, resnet_layers=18),
            variables, convert.load_regressor_weights(WEIGHTS, "cpu"))


@pytest.fixture(scope="module")
def both_assets():
    return jassets.synthesize_assets(), synthesize_assets()


def assert_metrics_agree(got, want, what):
    assert set(got) == set(want), what
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            for k in want if isinstance(want[k], float)}
    for k in want:
        if not isinstance(want[k], float):
            assert got[k] == want[k], (what, k)
    print("%s relative gap per metric: max %.3g %s"
          % (what, max(gaps.values()), gaps))
    assert max(gaps.values()) <= EVAL_REL, (what, gaps)


def test_fit_corruption_drops_no_joint_and_keeps_the_stream():
    rng = jax.random.PRNGKey(12)
    b, wh = 3, 64
    sil = np.ones((b, wh, wh), np.float32)
    j2d = np.random.RandomState(1).uniform(0, wh, (b, 17, 2)).astype(
        np.float32)
    want = jstraps.corrupt_proxy_inputs(rng, jnp.asarray(sil),
                                        jnp.asarray(j2d), drop_p=0.0,
                                        return_scores=True)
    d = jax_corruption_draws(rng, b, wh, 0.0)
    assert not bool(d.dropped.any())
    # The other draws do not depend on the rate.
    d8 = jax_corruption_draws(rng, b, wh, 0.08)
    for f in ("jitter", "score_noise", "cut_active", "cut_centre",
              "cut_half"):
        assert torch.equal(getattr(d, f), getattr(d8, f)), f
    got = tstraps.corrupt_proxy_inputs(d, _t(sil), _t(j2d),
                                       return_scores=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    assert (got[2].numpy() > 0).all()          # no joint scored as dropped
    # The port's own sampler: the same stream at either rate, none dropped
    # at 0.0.
    p0 = tstraps.sample_corruption_draws(torch.Generator().manual_seed(3),
                                         64, wh, drop_p=0.0)
    p8 = tstraps.sample_corruption_draws(torch.Generator().manual_seed(3),
                                         64, wh)
    assert not bool(p0.dropped.any()) and bool(p8.dropped.any())
    for f in ("jitter", "score_noise", "cut_active", "cut_centre",
              "cut_half"):
        assert torch.equal(getattr(p0, f), getattr(p8, f)), f
    fd = tstraps.sample_fit_draws(torch.Generator().manual_seed(3), 4, wh)
    assert fd.crop.occluder is not None
    assert not bool(fd.corruption.dropped.any())


def test_synth_fit_batch_matches_jax(both_assets):
    """The fit batch from JAX's draws: fit targets, scores, proxies."""
    ja, ta = both_assets
    rng = jax.random.fold_in(jax.random.PRNGKey(20_000_000), 0)
    want = jstraps.synth_fit_batch(ja, rng, b=2, wh=WH)
    k_synth, k_corrupt = jax.random.split(rng)
    got = tstraps.synth_fit_batch(ta, tstraps.RegressorDraws(
        jax_crop_draws(k_synth, 2), jax_corruption_draws(k_corrupt, 2, WH,
                                                         0.0)), wh=WH)
    assert set(got) == set(want)
    assert got["joints2d_fit"].shape == (2, 17, 3)
    for k in ("target_pose", "target_betas", "gt_cam_wp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["joints2d_fit"].numpy(),
                               np.asarray(want["joints2d_fit"]), rtol=0,
                               atol=1e-3)
    sil_apart = np.mean(got["silhouette"].numpy()
                        != np.asarray(want["silhouette"]))
    print("fit batch silhouette pixels apart: %.3g" % sil_apart)
    assert sil_apart <= 1e-3       # boundary pixels (test_torch_synth_eval)


def test_evaluate_fit_3d_matches_jax(both_assets, models):
    ja, ta = both_assets
    jmodel, variables, tmodel = models
    want = jstraps.evaluate_fit_3d(
        jmodel, variables["params"], variables["batch_stats"], ja,
        n_batches=1, batch=2, wh=WH,
        fit_cfg=JFitConfig(use_pallas=False, **KNOBS))
    rng = jax.random.fold_in(jax.random.PRNGKey(20_000_000), 0)
    k_synth, k_corrupt = jax.random.split(rng)
    draws = [tstraps.RegressorDraws(
        jax_crop_draws(k_synth, 2),
        jax_corruption_draws(k_corrupt, 2, WH, 0.0))]
    got = tstraps.evaluate_fit_3d(tmodel, ta, wh=WH,
                                  fit_cfg=FitConfig(**KNOBS), draws=draws,
                                  device="cpu")
    assert got["n_images"] == 2 and got["fit_iters"] == ITERS
    assert_metrics_agree(got, want, "evaluate_fit_3d")
