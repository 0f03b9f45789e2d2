"""The port's multi-view, broadcast-view and calc-metrics stages
(``drivers/stages.py``) against the JAX package's, on the tree and with
the regressors and bars of tests/test_torch_stages.py.

Both sides start from the same files: the JAX single-view stage's results
(joints-only), and for the broadcast stage the JAX multi-view stage's, so
every difference is the stage's own. The multi-view stage meets a player
with fewer views than the tree's most (player 3 lost one single-view
result), whose last view is repeated, as in JAX; the stored fits' cameras
are computed on the host in numpy float32 on both sides, so the
calc-metrics inits are bit-equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.drivers import stages as jst  # noqa: E402

from soccerplayershapepose_torch.drivers import stages as tst  # noqa: E402

from test_torch_stages import (  # noqa: E402,F401
    BATCH, JOINTS_TOL, assert_means_agree, assert_trees_agree, fit_configs,
    runtime, tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sv_root(tmp_path_factory, tree, runtime):
    """JAX's single-view results (joints-only, 3 iterations); player 3's
    second view removed."""
    ja, jvars, jfn, _, _ = runtime
    root = tmp_path_factory.mktemp("sv")
    jst.single_view_optimization(
        ja, tree["img"], tree["prx"], str(root), params=jvars,
        regressor_fn=jfn, fit_cfg=fit_configs(iters=3)[0], batch_size=BATCH,
        verbose=False)
    os.remove(root / "g1" / "s1" / "3" / "view1.npz")
    return str(root)


@pytest.fixture(scope="module")
def mv_root(tmp_path_factory, tree, runtime, sv_root):
    ja = runtime[0]
    root = tmp_path_factory.mktemp("mv")
    jst.multi_view_optimization(ja, tree["img"], tree["prx"], sv_root,
                                str(root), fit_cfg=fit_configs(iters=2)[0],
                                batch_size=BATCH, rounds=1,
                                iters_per_phase=2, verbose=False)
    return str(root)


def test_multi_view_matches_jax(tmp_path, tree, runtime, sv_root, mv_root):
    ja, _, _, ta, _ = runtime
    want = jst.multi_view_optimization(
        ja, tree["img"], tree["prx"], sv_root, str(tmp_path / "j"),
        fit_cfg=fit_configs(iters=2)[0], batch_size=BATCH, rounds=2,
        iters_per_phase=2, verbose=False)
    got = tst.multi_view_optimization(
        ta, tree["img"], tree["prx"], sv_root, str(tmp_path / "t"),
        fit_cfg=fit_configs(iters=2)[1], batch_size=BATCH, rounds=2,
        iters_per_phase=2, verbose=False, device="cpu")
    assert got["count"] == 2               # players 2 and 3
    assert_means_agree(got, want)
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", JOINTS_TOL)
    assert files == ["g1/s1/2/data.npz", "g1/s1/2/metrics.xml",
                     "g1/s1/2/view0.npz", "g1/s1/2/view1.npz",
                     "g1/s1/3/data.npz", "g1/s1/3/metrics.xml",
                     "g1/s1/3/view0.npz"]


@pytest.mark.parametrize("is_refine", [False, True])
def test_broad_view_matches_jax(tmp_path, tree, runtime, mv_root, is_refine):
    ja, jvars, jfn, ta, tfn = runtime
    jc, tc = fit_configs(iters=3, lr=0.01)
    roots = {s: str(tmp_path / s) for s in ("j", "t")}
    if is_refine:
        # A broadcast result of player 2 scores below the threshold: only
        # player 3 is refitted.
        for r in roots.values():
            os.makedirs(os.path.join(r, "g1", "s1", "2"))
            with open(os.path.join(r, "g1", "s1", "2", "metrics.xml"),
                      "w") as f:
                f.write("[0.9, 3.0]")
    want = jst.broad_view_optimization(
        ja, tree["bimg"], tree["bprx"], mv_root, roots["j"], params=jvars,
        regressor_fn=jfn, fit_cfg=jc, batch_size=BATCH, verbose=False,
        is_refine=is_refine)
    got = tst.broad_view_optimization(
        ta, tree["bimg"], tree["bprx"], mv_root, roots["t"],
        regressor_fn=tfn, fit_cfg=tc, batch_size=BATCH, verbose=False,
        is_refine=is_refine, device="cpu")
    # Player 1 has a broadcast proxy but no multi-view result.
    assert got["count"] == (1 if is_refine else 2)
    assert_means_agree(got, want)
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", JOINTS_TOL)
    assert "g1/s1/3/data.npz" in files
    # The pose and betas are the multi-view result's, bit for bit.
    with np.load(os.path.join(roots["t"], "g1/s1/3/data.npz")) as got_z, \
            np.load(os.path.join(mv_root, "g1/s1/3/data.npz")) as mv:
        np.testing.assert_array_equal(got_z["body_pose"], mv["body_pose"])
        np.testing.assert_array_equal(got_z["betas"], mv["betas"])


@pytest.mark.parametrize("silhouette", [False, True])
def test_calc_initial_metrics_matches_jax(tree, runtime, sv_root,
                                          silhouette):
    ja, _, _, ta, _ = runtime
    jc, tc = fit_configs(silhouette=silhouette)
    want = jst.calc_initial_metrics(ja, tree["img"], tree["prx"], sv_root,
                                    fit_cfg=jc, batch_size=BATCH)
    got = tst.calc_initial_metrics(ta, tree["img"], tree["prx"], sv_root,
                                   fit_cfg=tc, batch_size=BATCH,
                                   device="cpu")
    assert got["count"] == want["count"] == 3
    assert abs(got["silh_iou"] - want["silh_iou"]) <= 1e-6
    assert abs(got["joint_err"] - want["joint_err"]) <= \
        1e-5 * abs(want["joint_err"])
    assert (got["silh_iou"] > 0) == silhouette


def test_stored_camera_is_jax_numpy_arithmetic():
    t = np.array([0.013, -0.2, 187.3], np.float32)
    want = [2 * 5000.0 / (64 * t[2] + 1e-9), t[0], t[1]]
    got = tst._cam_from_translation(t, 64)
    assert [type(x) for x in got] == [np.float32] * 3
    assert got == want
