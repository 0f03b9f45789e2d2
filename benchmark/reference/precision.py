"""The precision the plain reference computes in.

The configurations state float32 with TF32 off. The control that every
comparison must fail is the same reference one step lower, in TF32: on the
card through PyTorch's own TF32 switches, on the CPU (which has no TF32)
by rounding each operand of a matrix product or convolution to TF32's
10-bit mantissa, round to nearest even. Every contraction of the reference
goes through the functions here.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

_STATE = {"tf32": False}


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    if not _STATE["tf32"] or x.is_cuda or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def fp32():
    """Float32 with TF32 off, as the configurations state."""
    with _switches(False):
        yield


@contextlib.contextmanager
def tf32():
    """The control's precision: TF32 in every contraction."""
    with _switches(True):
        yield


@contextlib.contextmanager
def _switches(on: bool):
    saved = (_STATE["tf32"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _STATE["tf32"] = on
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (_STATE["tf32"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matmul(a, b):
    return torch.matmul(_round_tf32(a), _round_tf32(b))


def einsum(eq, *xs):
    return torch.einsum(eq, *(_round_tf32(x) for x in xs))


def linear(x, w, b=None):
    return F.linear(_round_tf32(x), _round_tf32(w), b)


def conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(_round_tf32(x), _round_tf32(w), b, stride, padding)
