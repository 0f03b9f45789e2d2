"""Process-group start-up for data- and model-parallel runs.

Counterpart of ``soccerplayershapepose_tpu/parallel/distributed.py``. JAX
starts one process per host and sees every device of the cluster; the port
starts one process per card (a rank) and joins them with
``torch.distributed``. Call :func:`initialize` once per process, before
:func:`~soccerplayershapepose_torch.parallel.mesh.make_mesh`; each rank
then fits or trains its slice of the global batch (``local_batch_slice``,
``mesh.shard_batch``).

The cluster is read from the arguments first, then from torchrun's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``),
then from the JAX package's (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, with the same meaning), so a
launcher of the JAX package starts the port unchanged. With none of them
the process runs alone and nothing is initialised.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

# How long a collective waits for the other ranks before it fails.
TIMEOUT_S = 600


def _init_method(address: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) is taken as it is."""
    return address if "://" in address else "tcp://" + address


def _from_env() -> tuple:
    """(address, world size, rank) from torchrun's variables, else from
    the JAX package's; None where absent. torchrun's address is
    ``env://``: its agent may already serve the store at that port."""
    env = os.environ
    if "MASTER_ADDR" in env and "MASTER_PORT" in env:
        address = "env://"
    else:
        address = env.get("JAX_COORDINATOR_ADDRESS")
    size = env.get("WORLD_SIZE", env.get("JAX_NUM_PROCESSES"))
    rank = env.get("RANK", env.get("JAX_PROCESS_ID"))
    return (address, None if size is None else int(size),
            None if rank is None else int(rank))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: DeviceLike = None) -> dict:
    """Join this process to its process group.

    Args:
      coordinator_address: ``host:port`` of rank 0 (or any
        ``init_method`` URL, such as ``file:///shared/path``).
      num_processes, process_id: world size and this rank.
      backend: the collectives' backend; by default NCCL for CUDA and gloo
        for the CPU (``device``).
      device: the rank's device; None is the CUDA card (``LOCAL_RANK``'s
        where several are visible), and raises where there is none.

    Returns {'process_id', 'num_processes', 'local_devices',
    'global_devices'}: one device per rank. Already initialised, or given
    no cluster at all, it initialises nothing and reports what is there.
    """
    env_addr, env_size, env_rank = _from_env()
    coordinator_address = coordinator_address or env_addr
    num_processes = num_processes if num_processes is not None else env_size
    process_id = process_id if process_id is not None else env_rank

    if not dist.is_initialized() and (coordinator_address or num_processes):
        if not (coordinator_address and num_processes is not None
                and process_id is not None):
            raise ValueError(
                "a process group needs an address, a world size and a rank; "
                "got %r, %r, %r" % (coordinator_address, num_processes,
                                    process_id))
        dev = default_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=_init_method(coordinator_address),
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return {"process_id": process_index(), "num_processes": process_count(),
            "local_devices": 1, "global_devices": process_count()}


def process_index() -> int:
    """This rank (0 where no process group is initialised)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 where no process group is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> tuple:
    """(start, size) of this rank's slice of a data-parallel batch."""
    per_rank = global_batch // process_count()
    return process_index() * per_rank, per_rank
