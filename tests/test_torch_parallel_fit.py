"""The port's sharded fits on two gloo CPU ranks against the JAX package's
``mesh=`` fits on two virtual CPU devices and against the port's own
one-process fit, on the same rows.

Joints-only here (no render; tests/test_torch_parallel_fit_sil.py holds
the silhouette fits):

* the single-view fit of 4 rows, the last a padded copy of the third
  (mask 0), 4 iterations at lr 0.01: without priors, with the mint
  chain's priors (``betas_prior=0.01``, ``rot_ortho_prior=0.05``: one
  all-reduce of ``|total|`` per iteration), and with the priors plus
  keypoint-confidence weighting (the joints-2D mean over the global
  visibility sum; ROADMAP.md §3 has the near-tie that keeps
  ``joints2d_scale=100`` out of this case). Parameters within 1e-5
  (translation 200×: t_z ≈ 2f/(wh·s)), metrics within 1e-5 relative,
  ``best_iter`` identical; both ranks return the same full result;
* the multi-view fit of 2 players × 2 views (``group_size=2``: the
  players shard, and with them their 4 rows), one round of 3 + 3
  iterations, to the same bars;
* rows (or, with ``group_size``, players) that are no multiple of the
  data axis raise ``ValueError``, as JAX's ``run_fit_loop`` does.

Every rank gets the global batch and returns every row (``fit/engine.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.fit import (  # noqa: E402
    FitConfig as JFitConfig, FitInit as JFitInit,
    single_view_fit as jsingle)
from soccerplayershapepose_tpu.fit import multi_view as jmv  # noqa: E402
from soccerplayershapepose_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jmake_mesh)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch import config as tcfg  # noqa: E402
from soccerplayershapepose_torch.convert import (  # noqa: E402
    assets_from_numpy, fit_init_from_numpy)
from soccerplayershapepose_torch.fit import (  # noqa: E402
    FitConfig, MultiViewInit, multi_view_fit, single_view_fit)
from soccerplayershapepose_torch.ops import (  # noqa: E402
    batch_rodrigues, orthographic_project, undo_keypoint_normalisation)
from soccerplayershapepose_torch.smpl import smpl_forward  # noqa: E402

from test_torch_fit_views import render_targets  # noqa: E402
from torch_parallel_harness import Ranks  # noqa: E402

WH = 64
TOL = 1e-5
T_SCALE = 200
PARAMS = ("body_pose", "global_orient", "betas", "cam_wp")
JOINTS_ONLY = dict(iters=4, lr=0.01, proxy_wh=WH, use_silhouette=False,
                   silhouette_metrics=False, faces_per_chunk=86)
PRIORS = dict(betas_prior=0.01, rot_ortho_prior=0.05)
SINGLE_CASES = {
    "plain": JOINTS_ONLY,
    "priors": dict(JOINTS_ONLY, **PRIORS),
    "priors_conf": dict(JOINTS_ONLY, joint_conf_weighting=True, **PRIORS),
}
MV = dict(iters=3, lr=0.01, proxy_wh=WH, use_silhouette=False,
          silhouette_metrics=False, faces_per_chunk=86)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_rotmats(rng, shape, scale):
    aa = rng.randn(*shape, 3).astype(np.float32) * scale
    return batch_rodrigues(torch.from_numpy(aa.reshape(-1, 3))).reshape(
        shape + (3, 3)).numpy()


def perturb(rng, rot, scale=0.2):
    pert = random_rotmats(rng, rot.shape[:-2], scale)
    return np.einsum("...xy,...yz->...xz", rot, pert).astype(np.float32)


def assets_pair():
    ja = jassets.synthesize_assets()
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    return ja, ta


def targets(ja, rot, betas, cam, render):
    """(R, 64, 64) silhouettes (JAX's render, or zeros for the joints-only
    fits, which never read them) and (R, 17, 2) joints of R bodies (the
    port's SMPL: only the numbers matter, both packages fit to them)."""
    if render:
        return (np.array(x) for x in render_targets(ja, rot, betas, cam))
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    with torch.no_grad():
        out = smpl_forward(ta, torch.from_numpy(betas),
                           torch.from_numpy(np.ascontiguousarray(rot[:, 1:])),
                           torch.from_numpy(np.ascontiguousarray(rot[:, :1])))
        j2d = undo_keypoint_normalisation(orthographic_project(
            out.joints, torch.from_numpy(cam))[
                :, list(tcfg.SMPL_TO_KPRCNN_MAP)], WH).numpy()
    return np.zeros((len(rot), WH, WH), np.float32), j2d


def single_scene(ja, b, seed, pad_last=True, render=False):
    """b rows from known SMPL parameters (targets at 64² by JAX), a
    perturbed init; with ``pad_last`` the last row repeats the one before
    it and is masked out, as the stages pad. Joints carry a confidence
    channel."""
    rng = np.random.RandomState(seed)
    rot = np.array(random_rotmats(rng, (b, 24), 0.15))
    rot[:, 0] = np.einsum("bxy,yz->bxz", rot[:, 0],
                          np.diag([1.0, -1.0, -1.0]))     # face the camera
    betas = (rng.randn(b, 10) * 0.5).astype(np.float32)
    cam = np.stack([rng.uniform(0.8, 1.0, b), rng.uniform(-0.1, 0.1, b),
                    rng.uniform(-0.1, 0.1, b)], -1).astype(np.float32)
    sil, j2d = targets(ja, rot, betas, cam, render)
    conf = rng.uniform(0.2, 1.0, (b, 17, 1)).astype(np.float32)
    j2d = np.concatenate([j2d, conf], -1)
    noisy = perturb(rng, rot)
    init = [noisy[:, 1:], noisy[:, :1], (betas + 0.3).astype(np.float32),
            (cam + np.array([0.05, 0.02, -0.02])).astype(np.float32)]
    mask = np.ones(b, np.float32)
    if pad_last:
        for x in init + [sil, j2d]:
            x[-1] = x[-2]
        mask[-1] = 0.0
    return tuple(init), sil, j2d, mask


def views_scene(ja, b, v, seed):
    rng = np.random.RandomState(seed)
    body = random_rotmats(rng, (b, 23), 0.15)
    orient = random_rotmats(rng, (b, v, 1), 0.3)
    orient = np.einsum("bvjxy,yz->bvjxz", orient,
                       np.diag([1.0, -1.0, -1.0])).astype(np.float32)
    betas = (rng.randn(b, 10) * 0.5).astype(np.float32)
    cam = np.stack([rng.uniform(0.8, 1.0, (b, v)),
                    rng.uniform(-0.1, 0.1, (b, v)),
                    rng.uniform(-0.1, 0.1, (b, v))], -1).astype(np.float32)
    rot = np.concatenate([orient, np.broadcast_to(
        body[:, None], (b, v, 23, 3, 3))], axis=2)
    sil, j2d = targets(ja, rot.reshape(b * v, 24, 3, 3),
                       np.repeat(betas, v, 0), cam.reshape(b * v, 3), False)
    noisy = perturb(rng, rot)
    init = (noisy[:, :, 1:], noisy[:, :, :1],
            (betas[:, None] + rng.randn(b, v, 10) * 0.3).astype(np.float32),
            (cam + np.array([0.05, 0.02, -0.02])).astype(np.float32))
    return init, sil.reshape(b, v, WH, WH), j2d.reshape(b, v, 17, 2)


def jax_mesh():
    return jmake_mesh(jax.devices("cpu")[:2])


def jax_single(ja, scene, kw):
    init, sil, j2d, mask = scene
    res = jsingle(ja, JFitInit(*(jnp.asarray(x) for x in init)),
                  jnp.asarray(sil), jnp.asarray(j2d),
                  JFitConfig(use_pallas=False, **kw), jnp.asarray(mask),
                  mesh=jax_mesh())
    return {k: np.asarray(v) for k, v in res._asdict().items()
            if v is not None}


def port_single(ta, scene, kw):
    init, sil, j2d, mask = scene
    res = single_view_fit(ta, fit_init_from_numpy(*init), sil, j2d,
                          FitConfig(**kw), torch.from_numpy(mask),
                          device="cpu")
    return {k: v.numpy() for k, v in res._asdict().items() if v is not None}


def assert_fits_agree(got, want, tol, what, metrics=("silh_iou",
                                                     "joint_err")):
    """Parameters within ``tol`` (translation T_SCALE×), the metrics
    within 1e-5 relative, the best iterate identical where reported."""
    if "best_iter" in want:
        np.testing.assert_array_equal(got["best_iter"], want["best_iter"],
                                      err_msg=what)
    gaps = {}
    for k in PARAMS + ("translation",):
        t = tol * (T_SCALE if k == "translation" else 1)
        gaps[k] = float(np.abs(got[k] - want[k]).max())
        assert gaps[k] <= t, (what, k, gaps[k])
    for k in metrics:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg="%s %s" % (what, k))
    print(what, gaps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ja, ta = assets_pair()
    single = single_scene(ja, 4, seed=3)
    mv = views_scene(ja, 2, 2, seed=4)
    ragged = single_scene(ja, 3, seed=5, pad_last=False)
    mv_ragged = tuple(np.concatenate([x, x[:1]]) for x in mv[0]), \
        np.concatenate([mv[1], mv[1][:1]]), np.concatenate([mv[2], mv[2][:1]])
    cases = [(name, "single", dict(cfg=kw, init=single[0], sil=single[1],
                                   j2d=single[2], mask=single[3]))
             for name, kw in SINGLE_CASES.items()]
    mv_kw = dict(cfg=MV, rounds=1, iters=3)
    cases += [("multi_view", "multi", dict(mv_kw, init=mv[0], sil=mv[1],
                                            j2d=mv[2])),
              ("ragged_rows", "single", dict(
                  cfg=JOINTS_ONLY, init=ragged[0], sil=ragged[1],
                  j2d=ragged[2])),
              ("ragged_groups", "multi", dict(
                  mv_kw, init=mv_ragged[0], sil=mv_ragged[1],
                  j2d=mv_ragged[2]))]
    ranks = Ranks("fits", 2, tmp_path_factory.mktemp("fits"), cases=cases)
    # JAX's and the port's one-process fits while the ranks run.
    want = {"jax": {}, "port": {}}
    for name, kw in SINGLE_CASES.items():
        want["jax"][name] = jax_single(ja, single, kw)
        want["port"][name] = port_single(ta, single, kw)
    jres = jmv.multi_view_fit(
        ja, jmv.MultiViewInit(*(jnp.asarray(x) for x in mv[0])),
        jnp.asarray(mv[1]), jnp.asarray(mv[2]),
        JFitConfig(use_pallas=False, **MV), rounds=1, iters_per_phase=3,
        mesh=jax_mesh())
    want["jax"]["multi_view"] = {k: np.asarray(v)
                                 for k, v in jres._asdict().items()}
    tres = multi_view_fit(ta, MultiViewInit(*mv[0]), mv[1], mv[2],
                          FitConfig(**MV), rounds=1, iters_per_phase=3,
                          device="cpu")
    want["port"]["multi_view"] = {k: v.numpy()
                                  for k, v in tres._asdict().items()}
    return ranks.wait(), want


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_sharded_single_view_fit_matches_jax_and_one_process(runs, case):
    ranks, want = runs
    got = ranks[0][case]
    for k, v in got.items():
        np.testing.assert_array_equal(ranks[1][case][k], v, err_msg=k)
    assert (got["best_iter"][:3] > 1).all()     # the fits moved
    assert_fits_agree(got, want["jax"][case], TOL, "%s vs JAX" % case)
    assert_fits_agree(got, want["port"][case], TOL,
                      "%s vs one process" % case)


def test_sharded_multi_view_fit_matches_jax_and_one_process(runs):
    ranks, want = runs
    got = ranks[0]["multi_view"]
    for k, v in got.items():
        np.testing.assert_array_equal(ranks[1]["multi_view"][k], v,
                                      err_msg=k)
    assert got["body_pose"].shape == (2, 23, 3, 3)
    assert got["cam_wp"].shape == (2, 2, 3)
    for who in ("jax", "port"):
        w = dict(want[who]["multi_view"])
        assert_fits_agree(got, w, TOL, "multi-view vs %s" % who,
                          metrics=("joint_err",))


@pytest.mark.parametrize("case", ["ragged_rows", "ragged_groups"])
def test_ragged_batch_is_refused(runs, case):
    ranks, _ = runs
    for r in ranks:
        assert "multiple of the data axis" in r[case]["error"]
