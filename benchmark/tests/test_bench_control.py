"""The check fails the control and a broken timed path.

The control is the plain reference computed in TF32 (emulated on the
CPU) put in the program's place; the faults break the package's timed
path underneath a run of the harness, which skips only its look for a
card. Sizes are cut so that the CPU runs each in seconds."""

import torch

from benchmark import harness
from benchmark.tests import tiny


def run(cell):
    return harness.run_cell(cell, tiny.SEED, 0.1, False, device="cpu")


def failed(res) -> list:
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


def test_the_control_fails_the_fit_check():
    import importlib
    cell = tiny.fit_cell()
    system = importlib.import_module("benchmark.systems.svfit")
    sut = system.System(cell.config, cell.traffic, tiny.SEED, "cpu")
    sut.call()
    got, ctl = sut.check(control=True)
    limits = cell.config["check"]["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got
    assert any(ctl[k] > v for k, v in limits.items()), ctl


def test_the_control_fails_the_frame_check():
    import importlib
    cell = tiny.frame_cell()
    system = importlib.import_module("benchmark.systems.frame")
    sut = system.System(cell.config, cell.traffic, tiny.SEED, "cpu")
    for _ in range(2):
        sut.call()
    got, ctl = sut.check(control=True)
    limits = cell.config["check"]["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got
    assert any(ctl[k] > v for k, v in limits.items()), ctl


def test_a_fit_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    res = run(tiny.fit_cell(iters=4))
    assert not res["correct"] and failed(res)


def _half_fit(orig):
    def fit(assets, init, sil, j2d, cfg, mask=None, device=None, mesh=None):
        h = init.betas.shape[0] // 2
        res = orig(assets, type(init)(*(x[:h] for x in init)), sil[:h],
                   j2d[:h], cfg, device=device)
        rest = init.betas.shape[0] - h

        def cat(a, b):
            return torch.cat([a, b.to(a.dtype)])
        return res._replace(
            body_pose=cat(res.body_pose, init.body_pose[h:]),
            global_orient=cat(res.global_orient, init.global_orient[h:]),
            betas=cat(res.betas, init.betas[h:]),
            cam_wp=cat(res.cam_wp, init.cam_wp[h:]),
            silh_iou=cat(res.silh_iou, torch.zeros(rest)),
            init_silh_iou=cat(res.init_silh_iou, torch.zeros(rest)),
            best_iter=cat(res.best_iter, torch.ones(rest)))
    return fit


def test_half_the_fit_batch_left_out_fails(monkeypatch):
    from soccerplayershapepose_torch.fit import single_view
    monkeypatch.setattr(single_view, "single_view_fit",
                        _half_fit(single_view.single_view_fit))
    res = run(tiny.fit_cell(iters=3, lr=0.01))
    assert not res["correct"] and failed(res)


def test_a_fit_answer_altered_where_produced_fails(monkeypatch):
    from soccerplayershapepose_torch.fit import single_view
    orig = single_view.single_view_fit

    def altered(*a, **k):
        res = orig(*a, **k)
        return res._replace(betas=res.betas + 0.1)

    monkeypatch.setattr(single_view, "single_view_fit", altered)
    res = run(tiny.fit_cell())
    assert not res["correct"] and failed(res)


def _wrap_pipeline(monkeypatch, change):
    from soccerplayershapepose_torch.pipeline import fullframe
    orig = fullframe.build_frame_pipeline

    def build(*a, **k):
        fn = orig(*a, **k)
        return lambda assets, frames: change(fn(assets, frames))

    monkeypatch.setattr(fullframe, "build_frame_pipeline", build)


def test_half_the_frame_slots_left_out_fails(monkeypatch):
    def half(out):
        k = out.scores.shape[1] // 2
        return out._replace(**{f: torch.cat([getattr(out, f)[:, :k],
                                             torch.zeros_like(
                                                 getattr(out, f)[:, k:])], 1)
                               for f in ("boxes", "scores", "joints2d",
                                         "vertices")})

    _wrap_pipeline(monkeypatch, half)
    res = run(tiny.frame_cell())
    assert not res["correct"] and failed(res)


def test_a_frame_answer_altered_where_produced_fails(monkeypatch):
    _wrap_pipeline(monkeypatch,
                   lambda out: out._replace(vertices=out.vertices + 0.01))
    res = run(tiny.frame_cell())
    assert not res["correct"] and failed(res) == ["verts_mm"]
