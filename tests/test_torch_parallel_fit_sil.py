"""The port's sharded single-view fit with the silhouette (K1/K2's plain
versions on the CPU, a 32² render) on two gloo CPU ranks, one row each,
against JAX's ``mesh=`` fit on two virtual CPU devices and the port's
one-process fit on the same 2 rows: 3 iterations at lr 1e-3, without the
priors here and with them in tests/test_torch_parallel_fit_priors.py.

Bars as tests/test_torch_fit.py's silhouette fit: parameters within 1e-4
(a tenth of one Adam step: the σ_px = 0.0026 px² sigmoid turns fp32-ulp
vertex gaps between the frameworks into gradient gaps that Adam
amplifies), translation 200×, IoU within 1e-6, joint error 1e-5
relative, ``best_iter`` identical. The silhouette term is a sum over rows
and pixels, so each rank's gradient is its own rows'; the priors' ``mag``
reads the global ``|total|`` (one scalar all-reduce an iteration).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel_fit import (  # noqa: E402
    T_SCALE, assets_pair, jax_single, port_single, single_scene)
from torch_parallel_harness import Ranks  # noqa: E402

SIL_TOL = 1e-4
SILHOUETTE = dict(iters=3, lr=1e-3, proxy_wh=64, render_wh=32,
                  faces_per_chunk=86)
PARAMS = ("body_pose", "global_orient", "betas", "cam_wp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def silhouette_case(tmp_path, kw, seed):
    """(the 2-rank fit on each rank, JAX's mesh fit, the port's one-process
    fit) of 2 rendered rows; the ranks run while the test process fits."""
    ja, ta = assets_pair()
    scene = single_scene(ja, 2, seed=seed, pad_last=False, render=True)
    ranks = Ranks("fits", 2, tmp_path, cases=[("sil", "single", dict(
        cfg=kw, init=scene[0], sil=scene[1], j2d=scene[2], mask=scene[3]))])
    want_jax = jax_single(ja, scene, kw)
    want_port = port_single(ta, scene, kw)
    return [r["sil"] for r in ranks.wait()], want_jax, want_port


def assert_silhouette_fits_agree(got, want, what):
    np.testing.assert_array_equal(got["best_iter"], want["best_iter"],
                                  err_msg=what)
    gaps = {}
    for k in PARAMS + ("translation",):
        gaps[k] = float(np.abs(got[k] - want[k]).max())
        assert gaps[k] <= SIL_TOL * (T_SCALE if k == "translation" else 1), \
            (what, k, gaps[k])
    for k in ("silh_iou", "init_silh_iou"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                   err_msg="%s %s" % (what, k))
    for k in ("joint_err", "init_joint_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg="%s %s" % (what, k))
    print(what, gaps)


def check_silhouette_case(result):
    ranks, want_jax, want_port = result
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    assert (ranks[0]["best_iter"] > 1).all()     # the fit moved
    assert_silhouette_fits_agree(ranks[0], want_jax, "vs JAX's mesh fit")
    assert_silhouette_fits_agree(ranks[0], want_port, "vs one process")


def test_sharded_silhouette_fit_matches_jax_and_one_process(tmp_path):
    check_silhouette_case(silhouette_case(tmp_path, SILHOUETTE, seed=1))
