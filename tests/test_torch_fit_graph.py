"""The fit loop's CUDA graph (``fit/engine.py``: ``graph_engages``,
``_GraphPlan``, ``plan_key``).

On the CPU:

* the engagement rule, case by case: CUDA tensors, no mesh, no snapshots,
  no silhouette warm-up, at least two iterations;
* the eager loop records ``fit.graph_iters`` 0 and no capture;
* the plan's logic with a stand-in capture (its "replay" runs the captured
  iteration eagerly): bit-equal to the eager loop, single-view and
  multi-view (groups of 3); a second call through a plan leaks nothing; a
  plan is captured once and replaced when its key changes;
* what a plan is keyed on, and the launch count of a captured graph;
* an iteration after the first builds no tensor from host data (a CUDA
  graph cannot hold such a copy).

On the card (``cuda``; skip without one): the graph against the eager
loop, bit for bit, at 8 rows × 128² for 10 iterations, through a reused
plan, in a multi-view fit, and K1/K2's launch counts under replay. The
bit-for-bit cases run under deterministic algorithms: the backward's
scatters (K2's gradient onto the vertices, the views' repeat) add
atomically, so without them two eager runs differ too.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch.fit import engine  # noqa: E402
from soccerplayershapepose_torch.fit import multi_view as mv  # noqa: E402
from soccerplayershapepose_torch.fit.engine import (  # noqa: E402
    FitConfig, FitInit)
from soccerplayershapepose_torch.fit.single_view import (  # noqa: E402
    single_view_fit)
from soccerplayershapepose_torch.ops.rotations import (  # noqa: E402
    batch_rodrigues)
from soccerplayershapepose_torch.render import band_raster  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.utils import profiling  # noqa: E402

RESULT = ("body_pose", "global_orient", "betas", "cam_wp", "translation",
          "silh_iou", "joint_err", "init_silh_iou", "init_joint_err",
          "best_iter")
MV_RESULT = ("body_pose", "betas", "global_orient", "cam_wp", "translation",
             "silh_iou", "joint_err")
GRAPH_ENGAGES = engine.graph_engages


@pytest.fixture(autouse=True)
def _fresh_plan(monkeypatch):
    monkeypatch.setattr(engine, "_PLAN", None)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_assets():
    """The stand-in SMPL with its first 400 faces: the dense CPU
    silhouette stays quick."""
    a = synthesize_assets()
    return dataclasses.replace(a, faces=a.faces[:400].contiguous())


def scene(assets, b, wh, seed, device="cpu"):
    """Targets rendered from random bodies (the fit's own evaluation), and
    a perturbed start: (init, silhouettes, joints2d)."""
    g = torch.Generator().manual_seed(seed)
    rot = batch_rodrigues(torch.randn(b, 24, 3, generator=g) * 0.15)
    betas = torch.randn(b, 10, generator=g) * 0.5
    cam = torch.tensor([[0.9, 0.0, 0.0]]).repeat(b, 1) \
        + torch.randn(b, 3, generator=g) * 0.02
    pert = batch_rodrigues(torch.randn(b, 24, 3, generator=g) * 0.1)
    noisy = rot @ pert
    dev = torch.device(device)
    a = assets.to(dev)
    with torch.no_grad():
        ev = engine.evaluate_fit(
            a, rot[:, 1:].to(dev), rot[:, :1].to(dev), betas.to(dev),
            cam.to(dev), torch.zeros(b, wh, wh, device=dev),
            torch.zeros(b, 17, 2, device=dev),
            FitConfig(proxy_wh=wh, render_wh=wh))
    sil = (ev["pred_sil"] > 0.5).float().cpu()
    j2d = torch.cat([ev["pred_j2d"].cpu(), torch.ones(b, 17, 1)], -1)
    init = FitInit(noisy[:, 1:], noisy[:, :1], betas + 0.3,
                   cam + torch.tensor([0.05, 0.02, -0.02]))
    return init, sil, j2d


def stand_in_capture(monkeypatch):
    """Let the graph path run on the CPU: it engages as on CUDA, and the
    "graph" replays the captured iteration eagerly. Returns the list of
    captures."""
    captures = []

    def capture(fn):
        captures.append(fn)
        return types.SimpleNamespace(replay=fn), {}

    monkeypatch.setattr(engine, "graph_engages", lambda dev, mesh, cfg:
                        GRAPH_ENGAGES(torch.device("cuda"), mesh, cfg))
    monkeypatch.setattr(engine, "_capture", capture)
    return captures


def eager_only(monkeypatch):
    monkeypatch.setattr(engine, "graph_engages", lambda *a: False)


def assert_equal_results(got, want, fields):
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), (k, (a.float() - b.float()).abs().max())


# -- the engagement rule ------------------------------------------------------

@pytest.mark.parametrize("device,mesh,kw,engages", [
    ("cuda", None, {}, True),
    ("cuda:0", None, {"iters": 2}, True),
    ("cuda", None, {"use_silhouette": False, "save_every": True,
                    "betas_prior": 0.01}, True),
    ("cpu", None, {}, False),
    ("cuda", "mesh", {}, False),
    ("cuda", None, {"snapshot_every": 5}, False),
    ("cuda", None, {"silh_warmup_iters": 10}, False),
    ("cuda", None, {"iters": 1}, False),
    ("cuda", None, {"iters": 0}, False),
])
def test_graph_engages_on_what_the_loop_can_observe(device, mesh, kw,
                                                    engages):
    mesh = object() if mesh else None
    assert GRAPH_ENGAGES(torch.device(device), mesh,
                         FitConfig(**kw)) is engages


def test_the_eager_loop_records_no_replayed_iteration(small_assets):
    init, sil, j2d = scene(small_assets, 2, 32, 0)
    with profiling.recording() as rec:
        single_view_fit(small_assets, init, sil, j2d,
                        FitConfig(iters=3, proxy_wh=32, render_wh=32),
                        device="cpu")
    summ = rec.summary()
    assert summ["counters"] == {"fit.graph_iters": 0.0}
    assert summ["spans"]["fit.iter"]["count"] == 3
    assert not [p for p in summ["spans"] if "fit.replay" in p]


# -- the plan, with a stand-in capture on the CPU -----------------------------

@pytest.mark.parametrize("kw", [
    {"render_wh": 32},
    {"use_silhouette": False, "silhouette_metrics": False,
     "save_every": True, "betas_prior": 0.01, "pose_prior": 0.01,
     "rot_ortho_prior": 0.01, "joint_conf_weighting": True},
])
def test_replayed_loop_equals_the_eager_loop(small_assets, monkeypatch, kw):
    init, sil, j2d = scene(small_assets, 3, 32, 1)
    cfg = FitConfig(iters=4, proxy_wh=32, **kw)
    mask = torch.tensor([1.0, 1.0, 0.0])
    eager_only(monkeypatch)
    want = single_view_fit(small_assets, init, sil, j2d, cfg, mask=mask,
                           device="cpu")
    captures = stand_in_capture(monkeypatch)
    with profiling.recording() as rec:
        got = single_view_fit(small_assets, init, sil, j2d, cfg, mask=mask,
                              device="cpu")
    assert len(captures) == 1
    assert_equal_results(got, want, RESULT)
    assert (want.best_iter > 1).any()          # the fit kept a later iterate
    summ = rec.summary()
    assert summ["counters"] == {"fit.graph_iters": 3.0,
                                "fit.graph_captures": 1.0}
    assert summ["spans"]["fit.iter"]["count"] == 4
    assert summ["spans"]["fit.iter/fit.replay"]["count"] == 3


def test_a_plan_is_reused_and_keeps_nothing_between_calls(small_assets,
                                                          monkeypatch):
    cfg = FitConfig(iters=3, proxy_wh=32, render_wh=32)
    first = scene(small_assets, 2, 32, 2)
    second = scene(small_assets, 2, 32, 3)
    eager_only(monkeypatch)
    want = single_view_fit(small_assets, *second, cfg, device="cpu")
    captures = stand_in_capture(monkeypatch)
    single_view_fit(small_assets, *first, cfg, device="cpu")
    plan = engine._PLAN
    held = single_view_fit(small_assets, *second, cfg, device="cpu")
    assert engine._PLAN is plan and len(captures) == 1
    assert_equal_results(held, want, RESULT)
    # The results are the caller's: the next call does not overwrite them.
    kept = held.betas.clone()
    single_view_fit(small_assets, *first, dataclasses.replace(cfg, iters=5),
                    device="cpu")
    assert engine._PLAN is plan and len(captures) == 1
    assert torch.equal(held.betas, kept)
    # Other rows: a new plan, the old one dropped.
    single_view_fit(small_assets, *scene(small_assets, 3, 32, 4), cfg,
                    device="cpu")
    assert engine._PLAN is not plan and len(captures) == 2


def test_multi_view_replayed_loop_equals_the_eager_loop(small_assets,
                                                        monkeypatch):
    b, v = 2, 3
    init, sil, j2d = scene(small_assets, b * v, 32, 5)
    mv_init = mv.MultiViewInit(
        init.body_pose.reshape(b, v, 23, 3, 3),
        init.global_orient.reshape(b, v, 1, 3, 3),
        init.betas.reshape(b, v, 10), init.cam_wp.reshape(b, v, 3))
    sil, j2d = sil.reshape(b, v, 32, 32), j2d.reshape(b, v, 17, 3)
    cfg = FitConfig(proxy_wh=32, render_wh=32)
    kw = dict(rounds=1, iters_per_phase=3, device="cpu")
    eager_only(monkeypatch)
    want = mv.multi_view_fit(small_assets, mv_init, sil, j2d, cfg, **kw)
    captures = stand_in_capture(monkeypatch)
    got = mv.multi_view_fit(small_assets, mv_init, sil, j2d, cfg, **kw)
    assert len(captures) == 2                  # phases A and B
    assert_equal_results(got, want, MV_RESULT)


def test_plan_key_names_what_an_iteration_reads(small_assets):
    init, sil, j2d = scene(small_assets, 2, 32, 6)
    trainable = {"betas": init.betas, "cam_wp": init.cam_wp}
    frozen = {"body_pose": init.body_pose}
    mask, w = torch.ones(2), torch.ones(2)
    cfg = FitConfig(iters=3, proxy_wh=32, render_wh=32)

    def key(**over):
        args = dict(assets=small_assets, trainable=trainable, frozen=frozen,
                    assemble=engine.evaluate_fit, target_silhouette=sil,
                    target_joints2d=j2d, mask=mask, metric_weights=w,
                    fit_cfg=cfg, group_size=1)
        args.update(over)
        return engine.plan_key(**args)

    base = key()
    assert key(fit_cfg=dataclasses.replace(cfg, iters=100)) == base
    assert key(trainable={k: v.clone() for k, v in trainable.items()}) \
        == base
    assert key(assets=small_assets.to("cpu")) == base
    for other in (
            key(fit_cfg=dataclasses.replace(cfg, lr=0.01)),
            key(fit_cfg=dataclasses.replace(cfg, render_wh=16)),
            key(group_size=2),
            key(assemble=engine.fit_metrics),
            key(trainable={"betas": init.betas}),
            key(frozen={"body_pose": init.body_pose.transpose(-1, -2)}),
            key(target_joints2d=j2d[..., :2]),
            key(assets=dataclasses.replace(small_assets,
                                           faces=small_assets.faces.clone()))):
        assert other != base
    torch.use_deterministic_algorithms(True)
    try:
        assert key() != base
    finally:
        torch.use_deterministic_algorithms(False)


def test_a_captured_graph_counts_its_launches_at_each_replay():
    band_raster.reset_launch_counts()
    band_raster.LAUNCHES["band_raster_fwd"] += 2      # launched eagerly
    with band_raster.graph_launches() as held:
        band_raster.LAUNCHES["band_raster_fwd"] += 1  # captured, not run
        band_raster.LAUNCHES["band_raster_bwd"] += 1
    assert band_raster.LAUNCHES == {"band_raster_fwd": 2,
                                    "band_raster_bwd": 0}
    assert held == {"band_raster_fwd": 1, "band_raster_bwd": 1}
    for _ in range(3):
        band_raster.add_launches(held)
    assert band_raster.LAUNCHES == {"band_raster_fwd": 5,
                                    "band_raster_bwd": 3}
    band_raster.reset_launch_counts()


def test_an_iteration_builds_no_tensor_from_host_data(small_assets,
                                                      monkeypatch):
    init, sil, j2d = scene(small_assets, 2, 32, 7)
    cfg = FitConfig(proxy_wh=32, render_wh=32)
    args = (small_assets, init.body_pose, init.global_orient, init.betas,
            init.cam_wp, sil, j2d, cfg)
    want = engine.evaluate_fit(*args)

    def refuse(*a, **k):
        raise AssertionError("a tensor built from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    got = engine.evaluate_fit(*args)
    for k in ("pred_j2d", "pred_sil", "iou", "joint_err", "bce_score"):
        assert torch.equal(got[k], want[k]), k


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the band kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def card_assets(cuda_device):
    return synthesize_assets(device=cuda_device)


@pytest.fixture
def deterministic(cuda_device, monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_graph_equals_the_eager_loop_on_card(card_assets, deterministic,
                                             monkeypatch):
    init, sil, j2d = scene(card_assets, 8, 128, 10, "cuda")
    cfg = FitConfig(iters=10, proxy_wh=128, render_wh=128)
    band_raster.reset_launch_counts()
    got = single_view_fit(card_assets, init, sil, j2d, cfg)
    assert band_raster.LAUNCHES == {"band_raster_fwd": 10,
                                    "band_raster_bwd": 10}
    eager_only(monkeypatch)
    want = single_view_fit(card_assets, init, sil, j2d, cfg)
    assert_equal_results(got, want, RESULT)
    assert (want.best_iter > 1).any()


@pytest.mark.cuda
def test_a_reused_plan_equals_a_fresh_eager_fit_on_card(card_assets,
                                                        deterministic,
                                                        monkeypatch):
    cfg = FitConfig(iters=10, proxy_wh=128, render_wh=128)
    first = scene(card_assets, 8, 128, 11, "cuda")
    second = scene(card_assets, 8, 128, 12, "cuda")
    with profiling.recording() as rec:
        single_view_fit(card_assets, *first, cfg)
        got = single_view_fit(card_assets, *second, cfg)
    assert rec.summary()["counters"] == {"fit.graph_iters": 18.0,
                                         "fit.graph_captures": 1.0}
    eager_only(monkeypatch)
    want = single_view_fit(card_assets, *second, cfg)
    assert_equal_results(got, want, RESULT)


@pytest.mark.cuda
def test_multi_view_graph_equals_the_eager_loop_on_card(card_assets,
                                                        deterministic,
                                                        monkeypatch):
    b, v = 4, 3
    init, sil, j2d = scene(card_assets, b * v, 128, 13, "cuda")
    mv_init = mv.MultiViewInit(
        init.body_pose.reshape(b, v, 23, 3, 3),
        init.global_orient.reshape(b, v, 1, 3, 3),
        init.betas.reshape(b, v, 10), init.cam_wp.reshape(b, v, 3))
    sil, j2d = sil.reshape(b, v, 128, 128), j2d.reshape(b, v, 17, 3)
    cfg = FitConfig(proxy_wh=128, render_wh=128)
    kw = dict(rounds=2, iters_per_phase=5)
    band_raster.reset_launch_counts()
    got = mv.multi_view_fit(card_assets, mv_init, sil, j2d, cfg, **kw)
    # 4 phases of 5 iterations, then one evaluation of the result
    assert band_raster.LAUNCHES == {"band_raster_fwd": 21,
                                    "band_raster_bwd": 20}
    eager_only(monkeypatch)
    want = mv.multi_view_fit(card_assets, mv_init, sil, j2d, cfg, **kw)
    assert_equal_results(got, want, MV_RESULT)


@pytest.mark.cuda
def test_replays_count_one_k1_and_one_k2_per_iteration(card_assets):
    init, sil, j2d = scene(card_assets, 8, 128, 14, "cuda")
    for iters in (2, 10, 7):
        band_raster.reset_launch_counts()
        single_view_fit(card_assets, init, sil, j2d,
                        FitConfig(iters=iters, proxy_wh=128, render_wh=128))
        assert band_raster.LAUNCHES == {"band_raster_fwd": iters,
                                        "band_raster_bwd": iters}, iters
