"""Segments of the port's training driver (``scripts/
train_perception_torch.py:train_segment``) against the JAX script's steps,
from JAX's state file and on JAX's own batches, on the CPU: the regressor
here (64² renders, B = 2, at the r05 fine-tune's rate 3e-5), ProxyNet in
``test_torch_train_perception_jax_proxynet.py`` (head width 8, 64² crops,
B = 2, rate 1e-3).

JAX's state comes from the JAX script's ``_regressor_setup`` or
``_proxynet_setup`` (the nets' variables drawn by the port's flax
initialisers, so that no flax net is initialised eagerly) and is moved to
step START = 10 of a 40-step schedule (both Adam counts and the step).
Steps START and START + 1 are each one segment of the port's: before it,
JAX's state is written by JAX's ``_save_state`` and the port resumes from
that file; its batch is JAX's of that step (``synth_regressor_batch`` or
``synth_crop_batch`` of ``fold_in(PRNGKey(seed + 1), i)``, through K3's
mirror: ``test_torch_e2e_eval.fast_raster``), given through the segment's
``batch_fn``. JAX takes the same step (the regressor's jitted whole, as
the script does; ProxyNet's with only the net and Adam's update compiled,
``test_torch_perception_train.JitNet``, since a whole-step jit rewrites the
losses' logarithms). Then:

* each segment returns 10 (steps remain) and logs its step;
* each step's losses within LOSS_REL relative (and ProxyNet's keypoint
  positives decided alike in both packages on these batches);
* the port's ``state.npz`` after each step, read back by JAX's
  ``_load_state``: every parameter within 2·lr(step) + PARAM_TOL of JAX's,
  those apart by more than PARAM_TOL (Adam's sign flips) under
  MAX_FLIP_SHARE of the scalars; the BN statistics within STATS_REL of
  their scale; the log-variances within LOG_VAR_TOL; both counts and the
  step one on.

XLA's fp32 reductions on the CPU round more than PyTorch's: where the flip
count or a BN statistic misses its bar against JAX, the port's own step in
fp64 arbitrates (the port must meet the bar against it, and lie closer to
it than JAX does). Measured: the regressor's first-block BN means are
1.0e-5 and 2.0e-5 of their scale from JAX's after a step and 1.4e-7 and
1.2e-7 from the fp64 step; on ProxyNet's second step 360,811 of 11.2 M
scalars are apart from JAX's, 106 from the fp64 step, whose distance from
JAX's is 360,761.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402
from soccerplayershapepose_tpu.train.checkpoint import _flatten  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import distill  # noqa: E402
from soccerplayershapepose_torch.train import perception as ptrain  # noqa

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401
from test_torch_extract import nest_flat  # noqa: E402
from test_torch_train_perception import cpu_args  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_perception as jscript  # noqa: E402
import train_perception_torch as tp  # noqa: E402

START, STEPS, SEG = 10, 40, 2
LOSS_REL = 2e-5
PARAM_TOL = 1e-6
STATS_REL = 1e-5
LOG_VAR_TOL = 1e-6
MAX_FLIP_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def port_drawn_init():
    """JAX's nets' ``init`` returns the variables of the port's net of the
    same configuration drawn by the port's flax initialisers (seed 0)."""
    mp = pytest.MonkeyPatch()

    def proxynet_init(self, rng, *a, **kw):
        net = ptrain.new_proxynet(torch.Generator().manual_seed(0),
                                  self.with_iuv, "cpu", self.channels)
        return nest_flat(convert.proxynet_flat_from_state_dict(
            net.state_dict()))

    def regressor_init(self, rng, *a, **kw):
        net = distill.new_regressor(self.in_channels, 0, "cpu",
                                    self.resnet_layers)
        return nest_flat(convert.regressor_flat_from_state_dict(
            net.state_dict(), net.resnet_layers))

    mp.setattr(JProxyNet, "init", proxynet_init)
    mp.setattr(JRegressor, "init", regressor_init)
    yield
    mp.undo()


def at_step(jstate, n):
    adam, sched = jstate.opt_state
    return jstate._replace(
        opt_state=(adam._replace(count=jnp.asarray(n, jnp.int32)),
                   sched._replace(count=jnp.asarray(n, jnp.int32))),
        step=jnp.asarray(n, jnp.int32))


def flat_of(jstate):
    return {k: np.asarray(v) for k, v in _flatten(
        {"params": jstate.params, "batch_stats": jstate.batch_stats,
         **({"log_vars": jstate.log_vars} if hasattr(jstate, "log_vars")
            else {})}).items()}


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


def assert_states_agree(got, want, ref, lr, what):
    """The port's variables after a step (``got``) against JAX's
    (``want``): each parameter within 2·lr + PARAM_TOL, the ones apart by
    more than PARAM_TOL (Adam's sign flips) under MAX_FLIP_SHARE, each BN
    statistic within STATS_REL of its scale, the log-variances within
    LOG_VAR_TOL. Where a flip count or a BN statistic misses its bar, the
    port's fp64 step (``ref``) arbitrates: the port must meet the bar
    against it and lie closer to it than JAX does."""
    flips = {"jax": 0, "ref": 0, "jax_ref": 0}
    total = 0
    arbitrated = []
    for k, w in want.items():
        g, r = got[k], ref[k]
        if k.startswith("batch_stats/"):
            if _rel(g, w) > STATS_REL:
                assert _rel(g, r) <= STATS_REL and _rel(g, r) < _rel(w, r), (
                    what, k, _rel(g, w), _rel(g, r), _rel(w, r))
                arbitrated.append((k, _rel(g, w), _rel(g, r), _rel(w, r)))
        elif k.startswith("log_vars/"):
            assert float(np.abs(g - w).max()) <= LOG_VAR_TOL, (what, k)
        else:
            gap = np.abs(g - w)
            far = gap > PARAM_TOL
            assert (gap[far] <= 2 * lr + PARAM_TOL).all(), (
                what, k, gap[far][:5])
            flips["jax"] += int(far.sum())
            flips["ref"] += int((np.abs(g - r) > PARAM_TOL).sum())
            flips["jax_ref"] += int((np.abs(w - r) > PARAM_TOL).sum())
            total += gap.size
    print("%s: of %d scalars, %d apart from JAX's, %d from the port's fp64 "
          "step (JAX's: %d); BN statistics held to the fp64 step: %s"
          % (what, total, flips["jax"], flips["ref"], flips["jax_ref"],
             arbitrated))
    if flips["jax"] > MAX_FLIP_SHARE * total:
        assert flips["ref"] <= MAX_FLIP_SHARE * total, (what, flips)
        assert flips["ref"] < flips["jax_ref"], (what, flips)


def run_both(kind, args, jax_step, jax_batch, port_batch):
    """Steps START .. START + SEG − 1, one segment of the port's each, from
    JAX's state saved by JAX before every step, and JAX's step on JAX's
    batch: per step (the port's logged losses, JAX's losses, the port's
    variables after the step as JAX's ``_load_state`` reads them, JAX's,
    the step's rate)."""
    setup = {"regressor": jscript._regressor_setup,
             "proxynet": jscript._proxynet_setup}[kind]
    model, tx, jstate = setup(args)
    jstate = at_step(jstate, START)
    step = jax_step(model, tx)
    base = jax.random.PRNGKey(args.seed + 1)
    sched = tp.make_schedule(args)
    state_path = os.path.join(args.ckpt_dir, "state.npz")
    out = []
    for i in range(START, START + SEG):
        batch = jax_batch(jax.random.fold_in(base, i))
        jscript._save_state(state_path, jstate)
        state_path_before = os.path.join(args.ckpt_dir, "before.npz")
        jscript._save_state(state_path_before, jstate)
        rc = tp.train_segment(args, kind, batch_fn=lambda j: port_batch(
            batch))
        assert rc == tp.SEGMENT_RC
        with open(os.path.join(args.ckpt_dir, "log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        assert log[-1]["step"] == i + 1 and len(log) == i + 1 - START
        back = jscript._load_state(state_path, jstate)
        assert int(back.step) == i + 1
        assert all(int(c.count) == i + 1 for c in back.opt_state)
        ref = port_step_fp64(kind, args, state_path_before, batch,
                             port_batch)
        jstate, m = step(jstate, batch)
        out.append((log[-1], {k: float(v) for k, v in m.items()},
                    flat_of(back), flat_of(jstate), ref, sched(i), batch))
    return out


def port_step_fp64(kind, args, state_path, batch, port_batch):
    """The port's step from ``state_path`` on ``batch`` in fp64: its
    variables after the step (as fp32 flax names)."""
    state = tp.load_state(state_path, tp.new_state(args, kind, "cpu"))
    net = tp._net(state).double()
    state.opt.params = list(net.parameters())
    if hasattr(state, "regressor"):
        state.log_vars = {k: v.detach().double().requires_grad_(True)
                          for k, v in state.log_vars.items()}
        state.opt.params += list(state.log_vars.values())
    state.opt.mu = [m.double() for m in state.opt.mu]
    state.opt.nu = [m.double() for m in state.opt.nu]
    a = synthesize_assets()
    a = dataclasses.replace(a, **{
        f.name: getattr(a, f.name).double() for f in dataclasses.fields(a)
        if f.name != "parents" and getattr(a, f.name).is_floating_point()})
    tp.make_step(kind)(state, a, {
        k: v.double() if v.is_floating_point() else v
        for k, v in port_batch(batch).items()})
    flat = tp._variables_flat(state)
    if hasattr(state, "regressor"):
        flat.update({"log_vars/" + k: v.detach().float().numpy()
                     for k, v in state.log_vars.items()})
    return flat


def assert_step_agrees(rec, jlosses, names, got, want, ref, lr, what):
    gaps = {k: abs(rec[k] - jlosses[j]) / max(abs(jlosses[j]), 1e-12)
            for k, j in names.items()}
    print("%s, step %d: losses' relative gaps %s" % (what, rec["step"],
                                                     gaps))
    assert max(gaps.values()) <= LOSS_REL, gaps
    assert set(got) == set(want) == set(ref)
    assert_states_agree(got, want, ref, lr, "%s, step %d"
                        % (what, rec["step"]))


def test_regressor_segment_matches_jax(fast_raster, tmp_path):
    # The r05 fine-tune's rate (scripts/tpu_queue_r5.sh).
    args = cpu_args(["regressor", "--steps", str(STEPS), "--segment",
                     "1", "--log-every", "1", "--batch", "2", "--wh",
                     "64", "--lr", "3e-5"], tmp_path)
    ja = jassets.load_assets()

    def jax_step(model, tx):
        step = jax.jit(jdistill.make_train_step(model, tx))

        def run(s, b):
            s2, m, _ = step(s, ja, b)
            return s2, m
        return run

    def jax_batch(key):
        return jstraps.synth_regressor_batch(
            ja, key, b=args.batch, wh=args.wh, corrupt=True, occluders=True,
            proxy_channels=args.proxy_channels)

    def port_batch(b):
        out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        out["proxy"] = out["proxy"].permute(0, 3, 1, 2).contiguous()
        return out

    for rec, jl, got, want, ref, lr, _ in run_both(
            "regressor", args, jax_step, jax_batch, port_batch):
        names = {"total": "loss", **{k: k for k in jl if k != "loss"}}
        assert set(names) | {"kind", "step", "steps_per_s"} == set(rec)
        assert_step_agrees(rec, jl, names, got, want, ref, lr, "regressor")
