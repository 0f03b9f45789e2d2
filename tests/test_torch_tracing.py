"""The port's span recorder (``utils/profiling.py``) on the CPU.

* off (the default) a span is one shared no-op: nothing recorded, no
  record function entered, ``torch.cuda.synchronize`` not called;
* paths join the names from the root; self time is a span's duration less
  the union of its children's;
* a span opened in a custom autograd ``backward``, or on a thread with no
  span open, takes the caller's span as parent;
* a ``torch.profiler`` session turns recording on, and the spans appear in
  its ``key_averages()`` as host operations, not as user annotations
  (which the profiler would copy onto the card's timeline);
* counters add tensors on their device and read them in ``summary()``;
* ``build_frame_pipeline(stage_times=)`` fills its four keys from the
  stage spans, enters no other span while recording is off and leaves
  nothing in the process's recorder; under
  ``recording()`` a call records the frame's spans and slot counters;
* a fit of 2 rows × 64², 3 iterations: 3 ``fit.iter`` spans, with
  ``smpl.forward``, ``raster.fwd`` and ``raster.bwd`` under each;
* ``--trace-dir`` on the command line writes the trace and prints the
  spans on standard error.
"""

import dataclasses
import json
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch import cli  # noqa: E402
from soccerplayershapepose_torch.fit import engine  # noqa: E402
from soccerplayershapepose_torch.fit.engine import (  # noqa: E402
    FitConfig, FitInit)
from soccerplayershapepose_torch.fit.single_view import (  # noqa: E402
    single_view_fit)
from soccerplayershapepose_torch.io import formats  # noqa: E402
from soccerplayershapepose_torch.models.detector import (  # noqa: E402
    PlayerDetector)
from soccerplayershapepose_torch.models.perception import (  # noqa: E402
    ProxyNet)
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.pipeline.fullframe import (  # noqa: E402
    build_frame_pipeline)
from soccerplayershapepose_torch.render import band_raster  # noqa: E402
from soccerplayershapepose_torch.render import softras  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.utils import profiling  # noqa: E402

STAGES = {"detect", "roi_align", "proxynet", "predict"}


@pytest.fixture(autouse=True)
def _empty_process_recorder():
    profiling.reset()
    yield
    profiling.reset()


def spans_of(summ) -> dict:
    return {p: r["count"] for p, r in summ["spans"].items()}


def test_off_records_nothing_and_calls_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=refuse))
    assert profiling.span("a") is profiling.span("b")
    stage = profiling.Stages(None, "cpu", prefix="frame.")
    assert stage("detect") is profiling.span("c")
    with profiling.span("a"), stage("detect"):
        profiling.count("n", torch.ones(3))
    assert profiling.summary() == {"spans": {}, "counters": {}}


def test_paths_nesting_and_self_time(monkeypatch):
    ticks = iter([0, 10, 30, 50, 60, 100, 200, 205])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    with profiling.recording() as rec:
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                pass
        with profiling.span("a"):
            pass
    got = rec.summary()["spans"]
    assert got == {"a": {"count": 2, "total_ns": 105, "self_ns": 75},
                   "a/b": {"count": 1, "total_ns": 20, "self_ns": 20},
                   "a/c": {"count": 1, "total_ns": 10, "self_ns": 10}}
    # Children on two threads may overlap: their union counts once.
    r = profiling.Recorder()
    r.spans += [(0, None, "p", 0, 100), (1, 0, "p/x", 10, 40),
                (2, 0, "p/y", 30, 60), (3, 0, "p/z", 90, 120)]
    assert r.summary()["spans"]["p"] == {"count": 1, "total_ns": 100,
                                         "self_ns": 40}


class _Doubled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        with profiling.span("op.fwd"):
            return 2 * x

    @staticmethod
    def backward(ctx, g):
        with profiling.span("op.bwd"):
            return 2 * g


def test_backward_and_worker_spans_take_the_callers_parent():
    x = torch.ones(4, requires_grad=True)
    with profiling.recording() as rec:
        with profiling.span("outer"):
            with profiling.span("outer.forward"):
                y = _Doubled.apply(x).sum()
            with profiling.span("outer.backward"):
                y.backward()
        with profiling.span("caller"):
            worker = threading.Thread(
                target=lambda: profiling.span("worker").__enter__()
                .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
        assert not worker.is_alive()
    assert spans_of(rec.summary()) == {
        "outer": 1, "outer/outer.forward": 1,
        "outer/outer.forward/op.fwd": 1, "outer/outer.backward": 1,
        "outer/outer.backward/op.bwd": 1, "caller": 1, "caller/worker": 1}
    assert torch.equal(x.grad, torch.full((4,), 2.0))


def test_the_profiler_turns_recording_on():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("traced.outer"):
            with profiling.span("traced.inner"):
                torch.ones(16, 16) @ torch.ones(16, 16)
        profiling.count("traced.n", 3)
    names = {e.key for e in prof.key_averages()}
    assert {"traced.outer", "traced.inner"} <= names
    assert not [e for e in prof.events() if e.name.startswith("traced.")
                and e.is_user_annotation]
    summ = profiling.summary()
    assert spans_of(summ) == {"traced.outer": 1,
                              "traced.outer/traced.inner": 1}
    assert summ["counters"] == {"traced.n": 3.0}
    assert profiling.span("after") is profiling.span("after.too")


def test_counters_add_tensors_without_a_host_read(monkeypatch):
    with profiling.recording() as rec:
        # A meta tensor has no data: any read on the host would raise.
        profiling.count("meta", torch.ones(5, device="meta"))
        profiling.count("meta", torch.ones((), device="meta"))
        assert rec.counters["meta"].device.type == "meta"
        for name in ("item", "__float__", "__int__", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name, lambda *a: 1 / 0)
        profiling.count("n", torch.tensor([True, False, True]))
        profiling.count("n", 4)
        profiling.count("n", torch.tensor(2))
        monkeypatch.undo()
    del rec.counters["meta"]
    assert rec.summary()["counters"] == {"n": 8.0}


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def tiny_nets():
    torch.manual_seed(0)
    return (PlayerDetector(channels=16).eval(),
            ProxyNet(with_iuv=False, channels=16).eval(),
            SingleInputRegressor(in_channels=18, resnet_layers=18).eval())


def test_frame_stages_fill_their_keys_from_the_spans(assets, tiny_nets,
                                                     monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: entered.append(name) or real(name))
    frames = torch.rand(2, 64, 96, 3)
    times = {}
    fn = build_frame_pipeline(*tiny_nets, max_players=3, crop_wh=64,
                              device="cpu", stage_times=times)
    fn(assets, frames)
    assert set(times) == STAGES and all(v > 0 for v in times.values())
    # Recording off, the stages time themselves and nothing inside them.
    assert entered == ["frame." + k for k in
                       ("detect", "roi_align", "proxynet", "predict")]
    first = dict(times)
    fn(assets, frames)
    assert all(times[k] > first[k] for k in STAGES)
    assert profiling.summary() == {"spans": {}, "counters": {}}

    plain = build_frame_pipeline(*tiny_nets, max_players=3, crop_wh=64,
                                 device="cpu")
    with profiling.recording() as rec:
        out = plain(assets, frames)
    summ = rec.summary()
    got = spans_of(summ)
    for path in ("frame", "frame/frame.detect",
                 "frame/frame.detect/frame.decode", "frame/frame.roi_align",
                 "frame/frame.proxynet",
                 "frame/frame.proxynet/frame.proxy_decode",
                 "frame/frame.predict", "frame/frame.predict/predict",
                 "frame/frame.predict/predict/predict.proxy",
                 "frame/frame.predict/predict/predict.regressor",
                 "frame/frame.predict/predict/smpl.forward"):
        assert got.pop(path) == 1, path
    assert got == {}
    assert summ["counters"] == {"frame.slots": 6.0,
                                "frame.valid_slots": float(out.valid.sum())}


def band_route(vertices, translation, faces, img_wh, focal_length,
               sigma=1e-5, render_wh=None, backface_cull=False, **_):
    """``render_silhouette`` through ``SoftSilhouetteBand`` (the kernels'
    plain versions), the route a CUDA fit takes."""
    v2d = softras.perspective_project(vertices, None, translation,
                                      focal_length=focal_length,
                                      img_wh=img_wh)
    return band_raster.soft_silhouette_band(v2d * (render_wh / img_wh),
                                            faces, render_wh, sigma,
                                            backface_cull)


def test_fit_iterations_hold_smpl_and_raster_spans(assets, monkeypatch):
    monkeypatch.setattr(engine, "render_silhouette", band_route)
    # A few hundred faces keep the dense plain raster quick.
    small = dataclasses.replace(assets, faces=assets.faces[:400])
    b = 2
    eye = torch.eye(3)
    init = FitInit(body_pose=eye.expand(b, 23, 3, 3).clone(),
                   global_orient=eye.expand(b, 1, 3, 3).clone(),
                   betas=torch.zeros(b, 10),
                   cam_wp=torch.tensor([[0.9, 0.0, 0.0]] * b))
    sil = torch.zeros(b, 64, 64)
    sil[:, 12:52, 26:38] = 1.0
    j2d = torch.rand(b, 17, 3, generator=torch.Generator().manual_seed(0))
    j2d[..., :2] *= 64
    j2d[..., 2] = 1.0
    with profiling.recording() as rec:
        single_view_fit(small, init, sil, j2d,
                        FitConfig(iters=3, proxy_wh=64, render_wh=64),
                        device="cpu")
    summ = rec.summary()["spans"]
    for path in ("fit.iter", "fit.iter/fit.forward",
                 "fit.iter/fit.forward/smpl.forward",
                 "fit.iter/fit.forward/raster.fwd", "fit.iter/fit.backward",
                 "fit.iter/fit.backward/raster.bwd", "fit.iter/fit.select",
                 "fit.iter/fit.step"):
        assert summ[path]["count"] == 3, path
    it = summ["fit.iter"]
    inside = sum(r["total_ns"] for p, r in summ.items()
                 if p.count("/") == 1 and p.startswith("fit.iter/"))
    assert it["self_ns"] == it["total_ns"] - inside


def test_trace_dir_prints_the_spans(tmp_path, capsys):
    rng = np.random.RandomState(0)
    prx = tmp_path / "proxies" / "g1" / "s1" / "2"
    img = tmp_path / "images" / "g1" / "s1" / "2"
    os.makedirs(prx)
    os.makedirs(img)
    open(img / "view0.png", "wb").close()
    np.save(prx / "view0_sil.npy",
            (rng.rand(512, 512) > 0.9).astype(np.uint8))
    formats.write_joints2d(str(prx / "view0_j2d.xml"), np.concatenate(
        [rng.uniform(100, 400, (17, 2)), np.ones((17, 1))], axis=1))
    log_dir = tmp_path / "trace"
    rc = cli.main(["--trace-dir", str(log_dir), "predict",
                   "--image-root", str(tmp_path / "images"),
                   "--proxy-root", str(tmp_path / "proxies"),
                   "--result-root", str(tmp_path / "out"),
                   "--device", "cpu"])
    assert rc == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == {"views": 1}
    rows = {line.split()[0]: line.split()[1:] for line in err.splitlines()
            if line.strip()}
    assert rows["span"] == ["count", "total_ms", "self_ms"]
    assert rows["predict"][0] == "1"
    assert rows["predict/smpl.forward"][0] == "1"
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "predict.regressor" for e in events)
