"""The collectives of the data- and model-parallel paths.

Under GSPMD the JAX package's sharded programs compute exactly what the
unsharded ones compute: a mean over a sharded batch axis is a global mean,
and XLA inserts the reductions. The port runs one process per rank, so
each global quantity is built here by hand, with the few collectives the
port needs:

* :func:`all_reduce_sum` (detached): counts and scalars, such as a loss
  denominator or the fit's ``|total|``;
* :func:`all_gather_rows` (detached): per-rank results along the leading
  axis, such as the fit's best parameters;
* :func:`sum_gradients`: every gradient summed over the data group in one
  flat all-reduce, so that replicas stay identical;
* :class:`GlobalBatchNorm`: batch norm over the data group's global batch
  (``models/resnet.py:BatchNorm2d`` under :func:`data_parallel`);
* :func:`copy_to_group` and :func:`gather_columns`: the two ends of a
  column-parallel dense layer (``models/ief.py``).

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
sums the upstream gradients over the ranks, so where every rank builds the
same scalar from a reduced value and backpropagates it, the gradients come
out world-size times too large. The reductions of values here are detached;
the differentiable ones say what their backward sends where.

Every helper takes a process group and is an identity where it is None
(one process, no group).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "data_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Inside, batch norm normalises by the data group's global batch and
    :func:`data_sum` sums over it (a train step's forward and backward both
    run inside). ``group`` None leaves everything local."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def current_data_group():
    """The group set by the innermost :func:`data_parallel`, or None."""
    return _DATA_GROUP.get()


def data_size() -> int:
    """The number of ranks in the current data group (1 outside
    :func:`data_parallel`)."""
    group = current_data_group()
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, detached (a new tensor on
    ``x``'s device, where the group's backend must reach it)."""
    t = x.detach().clone()
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_sum` over the current data group (``x`` itself,
    detached, outside :func:`data_parallel`)."""
    group = current_data_group()
    return x.detach() if group is None else all_reduce_sum(x, group)


def data_share(n_local: int, device) -> float:
    """n_local / (its sum over the data group): a local mean times this is
    the rank's share of the global mean. 1.0 outside
    :func:`data_parallel`."""
    group = current_data_group()
    if group is None:
        return 1.0
    n = torch.tensor(float(n_local), dtype=torch.float64, device=device)
    return n_local / float(all_reduce_sum(n, group))


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along dim 0 in rank order
    of ``group``; detached."""
    if group is None:
        return x.detach()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=0)


def gather_dict_rows(tree: dict, group, lead_dims: Optional[dict] = None
                     ) -> dict:
    """:func:`all_gather_rows` of every tensor of ``tree`` in ONE
    collective: each is flattened per row of its axis ``lead_dims[k]``
    (default 0; all of them hold the same rows), packed into one fp32
    buffer, gathered and unpacked. Integer tensors go through fp32 and
    must be exact there (|v| < 2^24)."""
    if group is None:
        return dict(tree)
    lead_dims = lead_dims or {}
    keys = list(tree)
    slabs, metas = [], []
    for k in keys:
        t = tree[k]
        d = lead_dims.get(k, 0)
        moved = t.movedim(d, 0)
        metas.append((k, d, tuple(moved.shape), t.dtype))
        slabs.append(moved.reshape(moved.shape[0], -1).to(torch.float32))
    packed = all_gather_rows(torch.cat(slabs, dim=1), group)
    out, col = {}, 0
    for (k, d, shape, dtype), slab in zip(metas, slabs):
        w = slab.shape[1]
        full = packed[:, col:col + w].reshape((packed.shape[0],) + shape[1:])
        out[k] = full.to(dtype).movedim(0, d).contiguous()
        col += w
    return out


def sum_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Sum every parameter's ``.grad`` over ``group`` in place, in one
    all-reduce of their concatenation (a missing gradient counts as 0 and
    is then set)."""
    if group is None:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of NCHW ``x`` over the global batch of
    ``group``.

    Forward: one all-reduce of [Σx, Σx², count] per channel, in fp64 so
    that the variance E[x²] − E[x]² keeps fp32's precision; the batch's
    mean and biased variance normalise ``x``. Backward: one all-reduce of
    the two gradient sums [Σdy, Σdy·x̂], from which every rank's input
    gradient is the global batch's; the weight and bias gradients stay
    local (the data group's gradient sum adds them up)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xd = x.detach().to(torch.float64)
        stats = torch.cat([xd.sum(dim=(0, 2, 3)),
                           (xd * xd).sum(dim=(0, 2, 3)),
                           torch.full((1,), float(x.numel() // c),
                                      dtype=torch.float64, device=x.device)])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps).to(x.dtype)
        mean32 = mean.to(x.dtype)
        xhat = (x - mean32[None, :, None, None]) * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.group, ctx.n = group, n
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        var32 = var.to(x.dtype)
        ctx.mark_non_differentiable(mean32, var32)
        return y, mean32, var32

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd = ctx.saved_tensors
        c = xhat.shape[1]
        sums = torch.cat([dy.sum(dim=(0, 2, 3)),
                          (dy * xhat).sum(dim=(0, 2, 3))])
        local = sums.clone()
        dist.all_reduce(sums, group=ctx.group)
        n = float(ctx.n)
        mean_dy = (sums[:c] / n)[None, :, None, None]
        mean_dy_xhat = (sums[c:] / n)[None, :, None, None]
        dx = (dy - mean_dy - xhat * mean_dy_xhat) \
            * (weight * invstd)[None, :, None, None]
        return dx, local[c:], local[:c], None, None


def global_batch_norm(bn, x: torch.Tensor, group) -> torch.Tensor:
    """``bn`` (a train-mode ``BatchNorm2d``) on ``x`` over the global batch
    of ``group``, its running statistics updated as flax does: the biased
    global variance, momentum ``bn.momentum`` (PyTorch's convention)."""
    y, mean, var = GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps,
                                         group)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean,
                                                     alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    return y


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w, i = ctx.width, ctx.index
        return g[..., i * w:(i + 1) * w].contiguous(), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``group``. The
    input end of a column-parallel layer: each rank's part of the layer
    gives only its share of the input's gradient."""
    return x if group is None else _CopyToGroup.apply(x, group)


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (B, k) concatenated along the last axis in rank
    order; backward takes this rank's k columns of the gradient (every rank
    holds the same full gradient, as the layers after it are replicated:
    summing it would count it once per rank)."""
    return x if group is None else _GatherColumns.apply(x, group)


def coalesced_sum(values: Sequence[torch.Tensor], group) -> list:
    """Several detached scalars summed over ``group`` in one all-reduce."""
    if group is None:
        return [v.detach() for v in values]
    flat = torch.stack([v.detach().reshape(()).to(torch.float32)
                        for v in values])
    dist.all_reduce(flat, group=group)
    return list(flat.unbind())
