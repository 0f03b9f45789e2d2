"""The port's folder-tree stages (``drivers/stages.py``) against the JAX
package's, on one tree: the predict stage and the single-view stage with
its variants (tests/test_torch_stages_views.py holds the multi-view,
broadcast-view and calc-metrics stages).

The tree (``test_torch_scene_tree.make_tree``) holds players 1, 2 and 3
of one scene, 2 narrow views and the broad one each, 64² proxies with the
corruption's jitter, scores and cut-outs. Both sides run the committed
``weights/regressor_18ch_f16.npz`` (JAX: its flax variables; the port:
``convert.load_regressor_weights``) at proxy_wh 64, in batches of 3 (so
the last batch is padded), and write to their own roots. The same set of
files is written on both sides, and their values agree within:

* predict: the regressor's bar, 1e-4 (tests/test_torch_predict.py;
  measured ~7e-7);
* joints-only fits: 1e-5 (tests/test_torch_fit_views.py), the silhouette
  fit (32² render, lr 1e-3): 1e-4; translations (t_z ≈ 200) within that
  bar × ``T_SCALE``; silhouette IoU 1e-6 absolute, joint errors 1e-5
  relative; the stage's returned means 1e-5 relative.

Also: player '1' is skipped where JAX skips it; the refine gate
(``_refine_gate``, ``_gather_views``) decides alike; ``skip_existing``
leaves the same views out.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.drivers import stages as jst  # noqa: E402
from soccerplayershapepose_tpu.fit import FitConfig as JFitConfig  # noqa
from soccerplayershapepose_tpu.io import formats as jio  # noqa: E402
from soccerplayershapepose_tpu.pipeline import predict as jpred  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.drivers import stages as tst  # noqa: E402
from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.pipeline.predict import (  # noqa: E402
    predict_smpl)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

from test_torch_scene_tree import make_tree, tree_files  # noqa: E402
from test_torch_synth_eval import _nest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
WH, RENDER, BATCH = 64, 32, 3
NET_TOL = 1e-4
JOINTS_TOL = 1e-5
SIL_TOL = 1e-4
T_SCALE = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_tree(root, n_players=3, first_player_id=1)
    return {"root": root, "img": str(root / "images"),
            "prx": str(root / "proxies"),
            "bimg": str(root / "broad_images"),
            "bprx": str(root / "broad_proxies")}


@pytest.fixture(scope="module")
def runtime():
    """(JAX assets, params, regressor fn; the port's assets and regressor
    fn), both on the committed weights at proxy_wh WH."""
    with np.load(WEIGHTS) as z:
        variables = _nest({k: z[k] for k in z.files})
    _, _, jfn = jpred.build_predictor(proxy_wh=WH)
    model = convert.load_regressor_weights(WEIGHTS, "cpu")

    def tfn(assets, sil, j2d):
        return predict_smpl(model, assets, sil, j2d, proxy_wh=WH,
                            device="cpu")

    return jassets.synthesize_assets(), variables, jfn, synthesize_assets(), tfn


def fit_configs(silhouette=False, **kw):
    common = dict(proxy_wh=WH, faces_per_chunk=86, **kw)
    if silhouette:
        common["render_wh"] = RENDER
    else:
        common.update(use_silhouette=False, silhouette_metrics=False)
    return JFitConfig(use_pallas=False, **common), FitConfig(**common)


def assert_trees_agree(jroot, troot, tol):
    """The same files under both roots; .npz arrays within ``tol``
    (translations ``tol`` × T_SCALE), metrics.xml IoU within 1e-6 and
    joint error 1e-5 relative, PNGs of the same shape. Returns the files."""
    files = tree_files(jroot)
    assert files == tree_files(troot)
    assert files
    for f in files:
        j, t = os.path.join(jroot, f), os.path.join(troot, f)
        if f.endswith(".npz"):
            with np.load(j) as zj, np.load(t) as zt:
                assert sorted(zj.files) == sorted(zt.files), f
                for k in zj.files:
                    assert zt[k].dtype == zj[k].dtype == np.float32, (f, k)
                    assert zt[k].shape == zj[k].shape, (f, k)
                    np.testing.assert_allclose(
                        zt[k], zj[k], rtol=0, atol=tol * (
                            T_SCALE if k == "translation" else 1),
                        err_msg=f"{f}:{k}")
        elif f.endswith("metrics.xml"):
            (ji, je), (ti, te) = jio.read_metrics(j), jio.read_metrics(t)
            assert abs(ti - ji) <= 1e-6, f
            assert abs(te - je) <= 1e-5 * max(abs(je), 1.0), f
        else:
            raise AssertionError("unexpected file " + f)
    return files


def assert_means_agree(got, want):
    assert set(got) == set(want)
    assert got["count"] == want["count"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1.0), k


def test_predict_stage_matches_jax(tmp_path, tree, runtime):
    ja, jvars, jfn, ta, tfn = runtime
    n_j = jst.predict_stage(ja, tree["prx"], tree["img"], str(tmp_path / "j"),
                            params=jvars, regressor_fn=jfn, batch_size=BATCH)
    n_t = tst.predict_stage(ta, tree["prx"], tree["img"], str(tmp_path / "t"),
                            regressor_fn=tfn, batch_size=BATCH, device="cpu")
    assert n_t == n_j == 6                 # player '1' included
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", NET_TOL)
    assert len(files) == 6 and files[0].startswith("g1/s1/1/")


def test_single_view_joints_only_matches_jax(tmp_path, tree, runtime):
    ja, jvars, jfn, ta, tfn = runtime
    jc, tc = fit_configs(iters=3)
    want = jst.single_view_optimization(
        ja, tree["img"], tree["prx"], str(tmp_path / "j"), params=jvars,
        regressor_fn=jfn, fit_cfg=jc, batch_size=BATCH, verbose=False)
    got = tst.single_view_optimization(
        ta, tree["img"], tree["prx"], str(tmp_path / "t"), regressor_fn=tfn,
        fit_cfg=tc, batch_size=BATCH, verbose=False, device="cpu")
    assert got["count"] == 4               # player '1' skipped
    assert_means_agree(got, want)
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", JOINTS_TOL)
    # One metrics.xml per player: its last view's (mirrored quirk).
    assert [f for f in files if f.endswith("metrics.xml")] == [
        "g1/s1/2/metrics.xml", "g1/s1/3/metrics.xml"]
    d = jio.read_fit_npz(str(tmp_path / "t" / "g1/s1/3/view1.npz"))
    _, err = jio.read_metrics(str(tmp_path / "t" / "g1/s1/3/metrics.xml"))
    assert d["translation"].shape == (1, 3) and np.isfinite(err)


def test_single_view_silhouette_under_refine_gate_matches_jax(
        tmp_path, tree, runtime):
    """The silhouette fit (32² render) on the players the refine gate
    lets through: player 3's multi-view error is below the threshold."""
    ja, jvars, jfn, ta, tfn = runtime
    mul = tmp_path / "mul"
    for player, err in (("2", 12.0), ("3", 4.0)):
        os.makedirs(mul / "g1" / "s1" / player)
        jio.write_metrics(str(mul / "g1" / "s1" / player / "metrics.xml"),
                          0.7, err)
    jc, tc = fit_configs(silhouette=True, iters=2, lr=1e-3)
    kw = dict(batch_size=BATCH, verbose=False, is_refine=True,
              mul_folder=str(mul), score_thresh=10.0)
    want = jst.single_view_optimization(
        ja, tree["img"], tree["prx"], str(tmp_path / "j"), params=jvars,
        regressor_fn=jfn, fit_cfg=jc, **kw)
    got = tst.single_view_optimization(
        ta, tree["img"], tree["prx"], str(tmp_path / "t"), regressor_fn=tfn,
        fit_cfg=tc, device="cpu", **kw)
    assert got["count"] == 2
    assert_means_agree(got, want)
    assert got["opt_iou"] > 0
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", SIL_TOL)
    assert all(f.startswith("g1/s1/2/") for f in files)


def test_single_view_test_snapshots_match_jax(tmp_path, tree, runtime):
    ja, jvars, jfn, ta, tfn = runtime
    jc, tc = fit_configs(iters=3)
    want = jst.single_view_optimization_test(
        ja, tree["img"], tree["prx"], str(tmp_path / "j"), params=jvars,
        regressor_fn=jfn, fit_cfg=jc, batch_size=BATCH, snapshot_every=2)
    got = tst.single_view_optimization_test(
        ta, tree["img"], tree["prx"], str(tmp_path / "t"), regressor_fn=tfn,
        fit_cfg=tc, batch_size=BATCH, snapshot_every=2, device="cpu")
    assert got == want == {"count": 4, "snapshots_per_view": 2}
    files = assert_trees_agree(tmp_path / "j", tmp_path / "t", JOINTS_TOL)
    assert "g1/s1/2/view0_epoch1.npz" in files
    assert "g1/s1/2/view0_epoch3.npz" in files
    assert len(files) == 4 * 3


def test_skip_existing_leaves_the_same_views_out(tmp_path, tree, runtime):
    ja, jvars, jfn, ta, tfn = runtime
    jc, tc = fit_configs(iters=1)
    for side in ("j", "t"):
        os.makedirs(tmp_path / side / "g1" / "s1" / "3")
        jio.write_fit_npz(str(tmp_path / side / "g1/s1/3/view0.npz"),
                          *[np.zeros(s, np.float32) for s in
                            ((1, 23, 3, 3), (1, 1, 3, 3), (1, 10), (1, 3))])
    want = jst.single_view_optimization(
        ja, tree["img"], tree["prx"], str(tmp_path / "j"), params=jvars,
        regressor_fn=jfn, fit_cfg=jc, batch_size=BATCH, verbose=False,
        skip_existing=True)
    got = tst.single_view_optimization(
        ta, tree["img"], tree["prx"], str(tmp_path / "t"), regressor_fn=tfn,
        fit_cfg=tc, batch_size=BATCH, verbose=False, skip_existing=True,
        device="cpu")
    assert got["count"] == want["count"] == 3
    assert_trees_agree(tmp_path / "j", tmp_path / "t", JOINTS_TOL)
    kept = jio.read_fit_npz(str(tmp_path / "t/g1/s1/3/view0.npz"))
    assert not kept["betas"].any()         # left as it was


@pytest.mark.parametrize("ignore_first,refine,skip", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, True), (True, False, True)])
def test_gather_views_and_refine_gate_match_jax(tmp_path, tree, ignore_first,
                                                refine, skip):
    mul = tmp_path / "mul"
    for player, err in (("1", 30.0), ("2", 10.0), ("3", 9.99)):
        os.makedirs(mul / "g1" / "s1" / player)
        jio.write_metrics(str(mul / "g1" / "s1" / player / "metrics.xml"),
                          0.5, err)
    os.remove(mul / "g1" / "s1" / "1" / "metrics.xml")    # no score: kept
    done = tmp_path / "done"
    os.makedirs(done / "g1" / "s1" / "2")
    open(done / "g1" / "s1" / "2" / "view1.npz", "wb").close()
    args = dict(ignore_first=ignore_first,
                skip_existing_root=str(done) if skip else None)
    jg = jst._refine_gate(str(mul), 10.0) if refine else None
    tg = tst._refine_gate(str(mul), 10.0) if refine else None
    want = jst._gather_views(tree["img"], tree["prx"], refine_filter=jg,
                             **args)
    got = tst._gather_views(tree["img"], tree["prx"], refine_filter=tg,
                            **args)
    assert [(n.player, v) for n, v in got] == [(n.player, v)
                                               for n, v in want]
    assert got
    if refine:
        assert "3" not in {n.player for n, _ in got}
