"""Spawned gloo ranks for the port's data- and model-parallel tests.

:func:`run_ranks` (or :class:`Ranks`) starts ``world`` processes with the
spawn start method (fork would copy a test process's threads and JAX
state), each running a task of this module (``name(rank, world,
init_file, **kwargs)``) on the CPU with one torch thread; the ranks meet
through a ``file://`` rendezvous in the test's temporary directory. Each
rank's return value (numpy arrays and Python values) comes back pickled;
a rank that raises, exits non-zero or outlives the timeout fails the test
with its traceback.

The tasks import the port only: the JAX side of each comparison runs in
the test process.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

# How long the ranks of one launch may take before the test fails.
TIMEOUT_S = 240


def _worker(rank, world, init_file, task, kwargs, out_dir):
    try:
        import torch
        torch.set_num_threads(1)
        result = globals()[task](rank, world, init_file, **kwargs)
        with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """``world`` spawned ranks running ``task``; :meth:`wait` joins them
    (the test process may work meanwhile) and returns their results in
    rank order."""

    def __init__(self, task: str, world: int, tmp_path, **kwargs):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.out_dir = os.path.join(str(tmp_path), "ranks_%s_%d"
                                    % (task, time.time_ns()))
        os.makedirs(self.out_dir)
        init_file = os.path.join(self.out_dir, "rendezvous")
        self.world = world
        self.procs = [ctx.Process(target=_worker, args=(
            r, world, init_file, task, kwargs, self.out_dir))
            for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.time() + TIMEOUT_S

    def wait(self) -> list:
        procs, out_dir = self.procs, self.out_dir
        try:
            for p in procs:
                p.join(max(self.deadline - time.time(), 0.1))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            errors = []
            for r in range(self.world):
                path = os.path.join(out_dir, "rank%d.err" % r)
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append("rank %d:\n%s" % (r, f.read()))
            assert not errors, "\n".join(errors)
            assert not late, "ranks %s outlived %d s" % (late, TIMEOUT_S)
            assert all(p.exitcode == 0 for p in procs), [
                p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        out = []
        for r in range(self.world):
            with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_ranks(task: str, world: int, tmp_path, **kw) -> list:
    """Run ``task`` on ``world`` spawned ranks; their results in rank
    order."""
    return Ranks(task, world, tmp_path, **kw).wait()


def _init(rank, world, init_file):
    from soccerplayershapepose_torch.parallel import initialize
    return initialize("file://" + init_file, world, rank, device="cpu")


def _np(tree):
    """Tensors of a (nested) result → numpy."""
    import torch
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_np(v) for v in tree)
    if hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def basics(rank, world, init_file, bn=None, ports=None):
    """The process group from arguments: topology, slice, an all-reduce,
    the (world, 1) and (1, world) grids, shard_batch, replicate and a
    global batch norm; then from torchrun's and from the JAX package's
    environment variables."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from soccerplayershapepose_torch.models.resnet import BatchNorm2d
    from soccerplayershapepose_torch.parallel import (
        initialize, local_batch_slice, make_mesh, replicate, shard_batch)
    from soccerplayershapepose_torch.parallel import (
        data_sharding as shard_batch_slice)
    from soccerplayershapepose_torch.parallel.collectives import (
        all_gather_rows, data_parallel)

    out = {"args": _init(rank, world, init_file)}
    out["slice"] = local_batch_slice(8)
    x = torch.arange(1.0, 5.0) + 4 * rank
    dist.all_reduce(x)
    out["all_reduce"] = x.numpy()
    dp, mp = make_mesh(), make_mesh(model_parallel=world)
    out["grids"] = [(m.shape, m.data_index, m.model_index) for m in (dp, mp)]
    batch = {"a": torch.arange(16.0).reshape(8, 2),
             "b": [np.arange(8), (torch.ones(8, 3) * rank,)]}
    out["shard"] = _np(shard_batch(batch, dp))
    out["shard_model_grid"] = _np(shard_batch(batch, mp))
    t = torch.full((3,), float(rank + 7))
    net = torch.nn.Linear(2, 2)
    with torch.no_grad():
        net.weight.fill_(rank)
    replicate({"t": t, "net": net}, dp)
    out["replicate"] = [t.numpy(), net.weight.detach().numpy()]
    out["gather_rows"] = all_gather_rows(torch.full((2, 2), float(rank)),
                                         dp.data_group).numpy()

    # A global batch norm on this rank's slice of the batch.
    xs, dys = (torch.from_numpy(bn[k])[shard_batch_slice(dp, len(bn[k]))]
               for k in ("x", "dy"))
    norm = BatchNorm2d(xs.shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(bn["w"]))
        norm.bias.copy_(torch.from_numpy(bn["b"]))
    xs = xs.clone().requires_grad_(True)
    with data_parallel(dp.data_group):
        y = norm.train()(xs)
        (y * dys).sum().backward()
    grads = [norm.weight.grad.clone(), norm.bias.grad.clone()]
    for g in grads:
        dist.all_reduce(g)
    out["bn"] = {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
                 "dw": grads[0].numpy(), "db": grads[1].numpy(),
                 "mean": norm.running_mean.numpy(),
                 "var": norm.running_var.numpy()}
    dist.destroy_process_group()

    # torchrun's variables, then the JAX package's.
    for key, env in (
            ("torchrun", {"MASTER_ADDR": "127.0.0.1",
                          "MASTER_PORT": str(ports[0]),
                          "WORLD_SIZE": str(world), "RANK": str(rank)}),
            ("jax_env", {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:%d"
                         % ports[1], "JAX_NUM_PROCESSES": str(world),
                         "JAX_PROCESS_ID": str(rank)})):
        saved = {k: os.environ.pop(k, None) for k in (
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID")}
        os.environ.update(env)
        try:
            info = initialize(device="cpu")
            y = torch.tensor([float(rank + 1)])
            dist.all_reduce(y)
            out[key] = dict(info, all_reduce=float(y), backend=str(
                dist.get_backend()))
            dist.destroy_process_group()
        finally:
            for k in env:
                os.environ.pop(k, None)
            os.environ.update({k: v for k, v in saved.items()
                               if v is not None})
    return out


def fits(rank, world, init_file, cases):
    """Each case ``(name, kind, kwargs)``: the port's sharded fit on the
    global batch, every rank's full result."""
    from soccerplayershapepose_torch.convert import fit_init_from_numpy
    from soccerplayershapepose_torch.fit import (
        FitConfig, MultiViewInit, multi_view_fit, single_view_fit)
    from soccerplayershapepose_torch.parallel import make_mesh
    from soccerplayershapepose_torch.smpl import synthesize_assets

    _init(rank, world, init_file)
    mesh = make_mesh()
    assets = synthesize_assets()
    out = {}
    for name, kind, kw in cases:
        fit_cfg = FitConfig(**kw["cfg"])
        try:
            if kind == "single":
                res = single_view_fit(
                    assets, fit_init_from_numpy(*kw["init"]), kw["sil"],
                    kw["j2d"], fit_cfg, kw.get("mask"), device="cpu",
                    mesh=mesh)
            else:
                res = multi_view_fit(
                    assets, MultiViewInit(*kw["init"]), kw["sil"],
                    kw["j2d"], fit_cfg, rounds=kw["rounds"],
                    iters_per_phase=kw["iters"], mask=kw.get("mask"),
                    device="cpu", mesh=mesh)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        out[name] = _np(res)
    return out


def stage(rank, world, init_file, image_root, proxy_root, result_root,
          weights, proxy_wh, batch_size, fit_kw):
    """The single-view stage on its rank of a (world, 1) grid, writing
    under ``result_root``/rank<r> (only rank 0 may write); its means."""
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.drivers import stages
    from soccerplayershapepose_torch.fit import FitConfig
    from soccerplayershapepose_torch.parallel import make_mesh
    from soccerplayershapepose_torch.pipeline.predict import predict_smpl
    from soccerplayershapepose_torch.smpl import synthesize_assets

    _init(rank, world, init_file)
    model = convert.load_regressor_weights(weights, "cpu")

    def regressor_fn(assets, sil, j2d):
        return predict_smpl(model, assets, sil, j2d, proxy_wh=proxy_wh,
                            device="cpu")

    return stages.single_view_optimization(
        synthesize_assets(), image_root, proxy_root,
        os.path.join(result_root, "rank%d" % rank),
        regressor_fn=regressor_fn, fit_cfg=FitConfig(**fit_kw),
        batch_size=batch_size, verbose=False, device="cpu",
        mesh=make_mesh())


def perception_step(rank, world, init_file, kind, state_dict, batch, ch, lr):
    """One ``shard_train_step`` of ProxyNet or the detector from
    ``state_dict`` (fresh Adam) on this rank's slice of ``batch``: the
    state dict after it and the losses it reports."""
    import torch
    from soccerplayershapepose_torch.models.detector import PlayerDetector
    from soccerplayershapepose_torch.models.perception import ProxyNet
    from soccerplayershapepose_torch.parallel import (
        make_mesh, replicate, shard_batch)
    from soccerplayershapepose_torch.train import perception as ptrain

    _init(rank, world, init_file)
    mesh = make_mesh()
    model = (ProxyNet(channels=ch) if kind == "proxynet"
             else PlayerDetector(channels=ch))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    replicate(model, mesh)
    state = ptrain.make_perception_state(model, lr)
    step = ptrain.shard_train_step(
        ptrain.make_proxynet_train_step() if kind == "proxynet"
        else ptrain.make_detector_train_step(), mesh)
    local = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                        mesh)
    state, losses = step(state, local)
    return {"state": _np(model.state_dict()), "losses": _np(losses),
            "step": state.step, "count": state.opt.count}


def distill_grid(rank, world, init_file, state_dict, log_vars, lr, batch):
    """One distillation step on a (world / 2, 2) grid from the regressor's
    ``state_dict`` and ``log_vars`` (fresh Adam) on this rank's slice of
    ``batch`` (numpy, the proxy NHWC): the metrics, the log-variances and
    (rank 0) the state dict gathered over the model axis."""
    import torch
    from soccerplayershapepose_torch.models.regressor import (
        SingleInputRegressor)
    from soccerplayershapepose_torch.parallel import make_mesh, shard_batch
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import distill

    _init(rank, world, init_file)
    mesh = make_mesh(model_parallel=2)
    reg = SingleInputRegressor(in_channels=18)
    reg.load_state_dict({k: torch.from_numpy(v)
                         for k, v in state_dict.items()})
    state = distill.make_train_state(reg, learning_rate=lr)
    with torch.no_grad():
        for k, v in log_vars.items():
            state.log_vars[k].copy_(torch.as_tensor(v))
    distill.shard_train_state(state, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch["proxy"] = batch["proxy"].permute(0, 3, 1, 2).contiguous()
    state, metrics, _ = distill.make_train_step(mesh=mesh)(
        state, synthesize_assets(), shard_batch(batch, mesh))
    full = distill.gather_regressor(state, mesh)
    return {"metrics": _np(metrics), "log_vars": _np(state.log_vars),
            "state": _np(full) if rank == 0 else None}
