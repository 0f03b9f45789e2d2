"""Precision pinning and device selection.

The geometry (projection, SMPL joint regression, rasterization) needs full
fp32: one bf16 ulp on a focal-length-5000 projection is about 2 px. PyTorch
computes fp32 matmuls in full precision by default but lets cuDNN use TF32,
so both switches are pinned off here, once, when the package imports this
module.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the CUDA card. Asking for CUDA where none exists raises:
    an entry point never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (device=%r) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path" % (device,))
    return dev


def as_f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """numpy array or tensor → contiguous fp32 tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, dtype=np.float32))
    return t.to(device=device if device is not None else t.device,
                dtype=torch.float32).contiguous()
