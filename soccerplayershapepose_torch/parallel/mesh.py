"""The (data, model) grid of ranks and its sharding helpers.

Counterpart of ``soccerplayershapepose_tpu/parallel/mesh.py``. JAX builds a
2-D device mesh and lets GSPMD place global arrays on it; the port runs one
process per rank and builds the same grid over ``torch.distributed``:
rank ``r`` sits at row ``r // model_parallel`` (its data shard) and column
``r % model_parallel`` (its model shard), as JAX reshapes its device list.

* ``data`` shards the player or crop batch: every rank of a column holds
  another slice of the batch, and the column's process group
  (``data_group``) sums what the global batch sums;
* ``model`` shards the large dense layers (``models/ief.py``): the ranks of
  a row hold another part of a layer's outputs and its process group
  (``model_group``) gathers them.

torch has no global arrays, so :func:`data_sharding` and
:func:`shard_batch` return this rank's slice of a leading axis, and
:func:`replicate` broadcasts rank 0's tensors. Without a process group the
mesh is (1, 1), its groups are None and every helper is an identity, so a
``mesh=`` path runs in one process too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups.

    ``shape`` is ``{"data": n, "model": m}`` as JAX's ``mesh.shape``;
    ``data_index`` / ``model_index`` are this rank's row and column;
    ``data_group`` joins the ranks of its column (same model shard, other
    batch slices), ``model_group`` those of its row. The groups are None
    where no process group is initialised."""
    shape: dict
    data_index: int = 0
    model_index: int = 0
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def n_data(self) -> int:
        return self.shape[AXES.data]

    @property
    def n_model(self) -> int:
        return self.shape[AXES.model]


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The (world / model_parallel, model_parallel) grid of the initialised
    process group; (1, 1) and no groups where there is none. Every rank
    must call this, in the same order as its other group creations: each
    group is made by all ranks."""
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError("model_parallel=%d needs a process group"
                             % model_parallel)
        return Mesh(shape={AXES.data: 1, AXES.model: 1})
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError("world size %d is not a multiple of model_parallel "
                         "%d" % (world, model_parallel))
    n_data = world // model_parallel
    grid = np.arange(world).reshape(n_data, model_parallel)
    data_group = model_group = None
    for col in range(model_parallel):
        g = dist.new_group([int(r) for r in grid[:, col]])
        if rank % model_parallel == col:
            data_group = g
    for row in range(n_data):
        g = dist.new_group([int(r) for r in grid[row]])
        if rank // model_parallel == row:
            model_group = g
    return Mesh(shape={AXES.data: n_data, AXES.model: model_parallel},
                data_index=rank // model_parallel,
                model_index=rank % model_parallel, rank=rank,
                data_group=data_group, model_group=model_group)


def data_sharding(mesh: Mesh, size: int) -> slice:
    """This rank's slice of a leading (batch) axis of ``size``, which must
    be a multiple of the data axis."""
    n = mesh.n_data
    if size % n:
        raise ValueError("a batch of %d is not a multiple of the data axis "
                         "(%d)" % (size, n))
    per = size // n
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of every (B, ...) tensor or array of a dict, list
    or tuple (nested), on the leading axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [shard_batch(v, mesh) for v in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") \
            else type(batch)(out)
    if isinstance(batch, (torch.Tensor, np.ndarray)) and batch.ndim >= 1:
        return batch[data_sharding(mesh, batch.shape[0])]
    return batch


def replicate(tree, mesh: Mesh):
    """Broadcast rank 0's tensors to every rank of the mesh, in place: a
    tensor, a module (parameters and buffers) or a dict, list or tuple of
    them. Returns ``tree``."""
    if mesh.data_group is None and mesh.model_group is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            replicate(t, mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            dist.broadcast(tree.data, src=0)
    return tree
