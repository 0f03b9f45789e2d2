"""Plain functional nets read straight from the committed flax weights.

ResNet-18 (the regressor's encoder and the perception nets' trunk), the
IEF head, the FPN and the heads of ProxyNet and of the player detector,
written as functions of a flat ``{flax name: tensor}`` dict loaded from the
``weights/*.npz`` files: conv kernels HWIO → OIHW, dense kernels (in, out),
batch norm in eval mode with eps 1e-5. Every 3×3 convolution pads 1, the
stem 7×7/2 pads 3, max-pool 3/2 pads 1, nearest 2× upsampling repeats. The
function names follow the published architectures, not the measured
package's modules; nothing here imports it.

:class:`OpCounter` adds up the multiply-adds of every convolution and
dense layer from their shapes: run a net on ``meta`` tensors under it to
count the work of an input size without computing anything.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.nn import functional as F

from benchmark.reference import precision

_COUNTER: list = []


class OpCounter:
    """Floating-point operations (2 per multiply-add) of the convolutions
    and dense layers run while it is active."""

    def __init__(self):
        self.flops = 0.0

    @contextlib.contextmanager
    def active(self):
        _COUNTER.append(self)
        try:
            yield self
        finally:
            _COUNTER.remove(self)


def _count(flops: float) -> None:
    for c in _COUNTER:
        c.flops += flops


def load_flat(path: str, device, keep=None) -> dict:
    """npz → {name: fp32 tensor} on ``device`` (``keep`` filters names)."""
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32),
                                   device=device)
                for k in z.files if keep is None or keep(k)}


def on_meta(w: dict) -> dict:
    return {k: torch.empty(v.shape, device="meta") for k, v in w.items()}


def conv(w: dict, name: str, x, stride: int = 1, bias: bool = True):
    k = w[f"params/{name}/kernel"]
    kh = k.shape[0]
    weight = k.permute(3, 2, 0, 1).contiguous()
    b = w.get(f"params/{name}/bias") if bias else None
    y = precision.conv2d(x, weight, b, stride, kh // 2)
    _count(2.0 * y.numel() * k.shape[0] * k.shape[1] * k.shape[2])
    return y


def bn(w: dict, name: str, x):
    return F.batch_norm(x, w[f"batch_stats/{name}/mean"],
                        w[f"batch_stats/{name}/var"],
                        w[f"params/{name}/scale"], w[f"params/{name}/bias"],
                        False, 0.0, 1e-5)


def dense(w: dict, name: str, x):
    k = w[f"params/{name}/kernel"]
    _count(2.0 * x.shape[0] * k.shape[0] * k.shape[1])
    return precision.linear(x, k.t(), w[f"params/{name}/bias"])


def resnet18_stages(w: dict, prefix: str, x):
    """The four stage outputs (strides 4, 8, 16, 32) of a ResNet-18."""
    x = F.relu(bn(w, f"{prefix}/BatchNorm_0",
                  conv(w, f"{prefix}/Conv_0", x, 2, bias=False)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for k in range(8):
        stage, first = k // 2, k % 2 == 0
        stride = 2 if (stage > 0 and first) else 1
        blk = f"{prefix}/BasicBlock_{k}"
        y = F.relu(bn(w, f"{blk}/BatchNorm_0",
                      conv(w, f"{blk}/Conv_0", x, stride, bias=False)))
        y = bn(w, f"{blk}/BatchNorm_1", conv(w, f"{blk}/Conv_1", y,
                                             bias=False))
        if f"params/{blk}/Conv_2/kernel" in w:
            x = bn(w, f"{blk}/BatchNorm_2",
                   conv(w, f"{blk}/Conv_2", x, stride, bias=False))
        x = F.relu(y + x)
        if not first:
            outs.append(x)
    return outs


def regressor(w: dict, proxy, init_params):
    """ResNet-18 over the proxy, then three IEF iterations from
    ``init_params`` (157,): (cam (B, 3), pose 6D (B, 144), betas (B, 10))."""
    feat = resnet18_stages(w, "ResNet_0", proxy)[-1].mean(dim=(2, 3))
    params = init_params.expand(feat.shape[0], init_params.shape[0])
    for _ in range(3):
        h = F.relu(dense(w, "IEFModule_0/Dense_0",
                         torch.cat([feat, params], 1)))
        h = F.relu(dense(w, "IEFModule_0/Dense_1", h))
        params = params + dense(w, "IEFModule_0/Dense_2", h)
    return params[:, :3], params[:, 3:147], params[:, 147:]


def up2(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def fpn_p2(w: dict, images):
    """The stride-4 FPN map of an R18-FPN trunk fed ``images·2 − 1``."""
    feats = resnet18_stages(w, "FPNTrunk_0/trunk", images * 2.0 - 1.0)
    lat = [conv(w, f"FPNTrunk_0/fpn/lateral{i}", f)
           for i, f in enumerate(feats)]
    outs = [lat[-1]]
    for li in lat[-2::-1]:
        outs.append(li + up2(outs[-1]))
    return conv(w, "FPNTrunk_0/fpn/smooth0", outs[-1])


def tower(w: dict, name: str, x):
    for i in range(2):
        x = F.relu(conv(w, f"{name}/Conv_{i}", x))
    return x


def proxynet(w: dict, images):
    """(kp_logits (B, H/4, W/4, 17), mask_logits (B, H, W)) of RGB crops
    (B, 3, H, W) in [0, 1]."""
    p2 = fpn_p2(w, images)
    kp = conv(w, "kp_out", tower(w, "kp_tower", p2))
    m = up2(tower(w, "mask_tower", p2))
    m = up2(F.relu(conv(w, "mask_up1", m)))
    m = F.relu(conv(w, "mask_up2", m))
    return kp.permute(0, 2, 3, 1), conv(w, "mask_out", m)[:, 0]


def detector(w: dict, images):
    """(centre logits, size (softplus), offset), each channels-last at
    stride 4, of frames (B, 3, H, W) in [0, 1]."""
    t = tower(w, "det_tower", fpn_p2(w, images))

    def last(x):
        return x.permute(0, 2, 3, 1)

    return (last(conv(w, "center_out", t)),
            F.softplus(last(conv(w, "size_out", t))),
            last(conv(w, "offset_out", t)))


def count_flops(fn, w: dict, *shapes) -> float:
    """Operations of ``fn(w, *inputs)`` on meta tensors of ``shapes``."""
    counter = OpCounter()
    with counter.active():
        fn(on_meta(w), *(torch.empty(s, device="meta") for s in shapes))
    return counter.flops
