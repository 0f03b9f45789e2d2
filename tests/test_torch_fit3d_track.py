"""The port's ``train/fit3d.py:evaluate_fit_3d_track`` against the JAX
package, on the draws of the JAX key stream: one batch of 2 players × 3
frames at wh = 64, the records' fit knobs for 2 iterations at a 32²
render, each metric ≤ 1e-3 relative (tests/test_torch_fit3d.py gives the
bar and its reasons; the measured gaps are printed).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.fit.engine import (  # noqa: E402
    FitConfig as JFitConfig)
from soccerplayershapepose_tpu.train import fit3d as jfit3d  # noqa: E402

from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.train import fit3d as tfit3d  # noqa: E402

from test_torch_fit3d import (  # noqa: E402,F401 (fixtures)
    KNOBS, WH, assert_metrics_agree, both_assets, jax_corruption_draws,
    models)
from test_torch_scenes import jax_track_draws  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluate_fit_3d_track_matches_jax(both_assets, models):
    ja, ta = both_assets
    jmodel, variables, tmodel = models
    b, t = 2, 3
    want = jfit3d.evaluate_fit_3d_track(
        jmodel, variables["params"], variables["batch_stats"], ja,
        n_batches=1, batch=b, n_frames=t, wh=WH,
        fit_cfg=JFitConfig(use_pallas=False, **KNOBS))
    rng = jax.random.fold_in(jax.random.PRNGKey(40_000_000), 0)
    draws = [tfit3d.TrackEvalDraws(
        jax_track_draws(rng, b, t),
        jax_corruption_draws(jax.random.fold_in(rng, 7), b * t, WH, 0.0))]
    got = tfit3d.evaluate_fit_3d_track(tmodel, ta, wh=WH,
                                       fit_cfg=FitConfig(**KNOBS),
                                       draws=draws, device="cpu")
    assert (got["n_players"], got["n_frames"]) == (b, t)
    assert_metrics_agree(got, want, "evaluate_fit_3d_track")
