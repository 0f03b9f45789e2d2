"""Data and model parallelism over ``torch.distributed``.

Counterpart of ``soccerplayershapepose_tpu/parallel/``: a (data, model)
grid of ranks (``mesh.py``), the process group's start-up
(``distributed.py``) and the collectives that build, by hand, the global
quantities GSPMD computes implicitly (``collectives.py``).
"""

from soccerplayershapepose_torch.parallel.mesh import (  # noqa: F401
    AXES, Mesh, MeshAxes, data_sharding, make_mesh, replicate, shard_batch)
from soccerplayershapepose_torch.parallel.distributed import (  # noqa: F401
    initialize, local_batch_slice)
