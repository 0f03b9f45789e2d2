"""The port's baseline evaluations with the silhouette on, against the JAX
package's: the silhouette rendered at 32² (the proxies' 512² targets
stride-subsampled to it) at lr 1e-3, the split ``test_torch_fit_views.py``
uses (at the stages' lr 0.01 fp32 gaps between the soft rasterizers grow
past 1e-4 over a few iterations). On the CPU both packages render with
their plain soft rasterizers; on the card the port's renders are K1 and
its gradient K2.

* ``evaluate_baseline_2d`` (optimised, 3 iterations) and
  ``evaluate_baseline_cross`` (fit view 0, measure view 1) for one player
  seen twice: IoU, joint error and the fitted parameters within 1e-4.

The multi-view fit with the silhouette is held in
``tests/test_torch_fit_views.py`` (``multi_view_fit``, which
``multi_view_optimization_multi`` calls); here its 2-row fit takes ~90 s
on one core, and one of its pose scalars takes an Adam sign flip (2e-3 at
lr 1e-3), so the baselines' multi-view layer is held joints-only in
``tests/test_torch_baselines.py``.

The targets are upright ellipses about where the predictions' bodies
project, so the IoU is neither 0 nor 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.drivers import baselines as jbase  # noqa: E402
from soccerplayershapepose_tpu.fit import FitConfig as JFitConfig  # noqa
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch.drivers import baselines as tbase  # noqa
from soccerplayershapepose_torch.fit.engine import FitConfig  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

from test_torch_baselines import predictions  # noqa: E402

TOL = 1e-4
SIL = dict(iters=3, lr=1e-3, render_wh=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ellipses(rs, shape):
    yy, xx = np.mgrid[:512, :512]
    n = int(np.prod(shape))
    c = rs.uniform(-20, 20, (n, 2)) + [256, 256]
    r = rs.uniform([40, 120], [70, 180], (n, 2))
    sil = ((((xx[None] - c[:, :1, None]) / r[:, :1, None]) ** 2
            + ((yy[None] - c[:, 1:, None]) / r[:, 1:, None]) ** 2) < 1)
    return sil.astype(np.float32).reshape(shape + (512, 512))


@pytest.fixture(scope="module")
def both_assets():
    return jassets.synthesize_assets(), synthesize_assets()


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.fixture(scope="module")
def case():
    """One player seen in two views."""
    rs = np.random.RandomState(3)
    return (predictions(rs, 1), ellipses(rs, (1, 2)),
            rs.uniform(150, 350, (1, 2, 17, 2)).astype(np.float32))


def test_2d_with_silhouette_matches_jax(both_assets, case):
    ja, ta = both_assets
    preds, sils, j2d = case
    want = jbase.evaluate_baseline_2d(ja, preds, sils[:, 0], j2d[:, 0],
                                      fit_cfg=JFitConfig(**SIL))
    got = tbase.evaluate_baseline_2d(ta, preds, sils[:, 0], j2d[:, 0],
                                     fit_cfg=FitConfig(**SIL), device="cpu")
    assert 0.0 < float(got["init_iou"].min()) < 1.0
    for k in ("init_iou", "init_err", "opt_iou", "opt_err"):
        close(got[k], want[k], k)
    for k in ("global_orient", "cam_wp"):
        close(getattr(got["result"], k).numpy(),
              getattr(want["result"], k), k)


def test_cross_with_silhouette_matches_jax(both_assets, case):
    ja, ta = both_assets
    preds, sils, j2d = case
    want = jbase.evaluate_baseline_cross(ja, preds, sils, j2d, 0, 1, 2,
                                         fit_cfg=JFitConfig(**SIL))
    got = tbase.evaluate_baseline_cross(ta, preds, sils, j2d, 0, 1, 2,
                                        fit_cfg=FitConfig(**SIL),
                                        device="cpu")
    assert 0.0 < float(got["silh_iou"][0]) < 1.0
    close(got["silh_iou"], want["silh_iou"], "cross silh_iou")
    close(got["joint_err"], want["joint_err"], "cross joint_err")
