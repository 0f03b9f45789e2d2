"""The reference's PyTorch checkpoints → the port's modules.

Counterpart of ``soccerplayershapepose_tpu/io/torch_import.py``. The
reference ships trained weights as torch ``.tar`` checkpoints (the STRAPS
regressor's ``best_model_state_dict``; the relation module's, or a bare
state dict). Its modules are PyTorch modules already, so the import is a
renaming onto the port's module names plus the one layout the two differ
in: the reference keeps each relation unit as its own ``nn.Linear``s
(``relation_module.relation.{i}.{WK,WQ,WV,WG}``), the port stacks the units
into one ``Linear`` per projection (unit-major rows).

* regressor: ``image_encoder.conv1`` / ``bn1`` → ``encoder.conv`` /
  ``encoder.norm``; ``image_encoder.layer{s}.{u}.conv{1,2}`` / ``bn{1,2}``
  / ``downsample.{0,1}`` → ``encoder.blocks.{2(s−1)+u}.convs.{0,1,2}`` /
  ``norms.{0,1,2}`` (ResNet-18); ``ief_module.fc{1,2,3}`` → ``ief.fcs.{0,
  1,2}``;
* relation (v0, or v1 with ``fc1`` / ``fc2`` → ``lift`` / ``proj_back``).

Files load with ``torch.load(..., weights_only=True)``: a checkpoint that
holds other pickled objects is refused with torch's own error.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.models.relation import PoseRelationModule
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

_BN = {"weight": "weight", "bias": "bias", "running_mean": "running_mean",
       "running_var": "running_var", "num_batches_tracked":
       "num_batches_tracked"}


def _f32(t) -> torch.Tensor:
    t = torch.as_tensor(t).detach().cpu()
    return t if t.dtype == torch.int64 else t.to(torch.float32)


def regressor_state_dict_from_reference(sd: Dict) -> dict:
    """The reference ``SingleInputRegressor`` state dict (torchvision-style
    ResNet-18 ``image_encoder``, IEF ``ief_module``) → the port's
    :class:`SingleInputRegressor` state dict, fp32."""
    out = {}
    for key, v in sd.items():
        if key.startswith("ief_module."):
            m = re.fullmatch(r"ief_module\.fc([123])\.(weight|bias)", key)
            if m is None:
                raise KeyError("unexpected IEF variable " + key)
            out["ief.fcs.%d.%s" % (int(m.group(1)) - 1, m.group(2))] = _f32(v)
            continue
        if not key.startswith("image_encoder."):
            raise KeyError("unexpected regressor variable " + key)
        rest = key[len("image_encoder."):]
        m = re.fullmatch(r"(conv1|bn1)\.(\w+)", rest)
        if m:
            mod = {"conv1": "encoder.conv", "bn1": "encoder.norm"}[m.group(1)]
            out["%s.%s" % (mod, _BN[m.group(2)])] = _f32(v)
            continue
        m = re.fullmatch(
            r"layer([1-4])\.(\d+)\.(conv[12]|bn[12]|downsample\.[01])\.(\w+)",
            rest)
        if m is None:
            raise KeyError("unexpected encoder variable " + key)
        block = 2 * (int(m.group(1)) - 1) + int(m.group(2))
        part = {"conv1": "convs.0", "conv2": "convs.1", "bn1": "norms.0",
                "bn2": "norms.1", "downsample.0": "convs.2",
                "downsample.1": "norms.2"}[m.group(3)]
        out["encoder.blocks.%d.%s.%s" % (block, part, _BN[m.group(4)])] = \
            _f32(v)
    return out


def relation_state_dict_from_reference(sd: Dict) -> dict:
    """The reference ``PoseRelationModule`` state dict (v0:
    ``relation_module.relation.{i}.{WG,WK,WQ,WV}``; v1: also ``fc1`` and
    ``fc2``) → the port's :class:`PoseRelationModule` state dict: each
    projection's units stacked unit-major (``WK.weight`` (H·dk, F),
    ``WG.weight`` (H, G))."""
    pre = "relation_module.relation."
    units = sorted({int(k[len(pre):].split(".")[0])
                    for k in sd if k.startswith(pre)})
    if not units or units != list(range(len(units))):
        raise ValueError(
            "state dict does not look like a reference PoseRelationModule "
            f"(found relation unit indices {units})")

    def stack(name: str, attr: str) -> torch.Tensor:
        return torch.cat([_f32(sd[f"{pre}{i}.{name}.{attr}"])
                          for i in units])

    out = {}
    for name in ("WQ", "WK", "WV", "WG"):
        out[name + ".weight"] = stack(name, "weight")
        out[name + ".bias"] = stack(name, "bias")
    if "fc1.weight" in sd:
        for src, dst in (("fc1", "lift"), ("fc2", "proj_back")):
            out[dst + ".weight"] = _f32(sd[src + ".weight"])
            out[dst + ".bias"] = _f32(sd[src + ".bias"])
    return out


def _relation_module(sd: dict) -> PoseRelationModule:
    """The :class:`PoseRelationModule` that ``sd`` (the port's names)
    fits: units from ``WG``'s rows, their width from ``WK``'s rows."""
    h, geo = sd["WG.weight"].shape
    lift = sd.get("lift.weight")
    return PoseRelationModule(
        n_relations=int(h), key_dim=int(sd["WK.weight"].shape[0] // h),
        geo_dim=int(geo),
        lift_dim=None if lift is None else int(lift.shape[0]))


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _pick(ckpt, key: str) -> dict:
    return ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt


def _load_into(model, sd: dict, path: str, what: str):
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError("%s does not fit %s: missing %s, unexpected %s"
                         % (path, what, missing[:5], unexpected[:5]))
    return model


def load_straps_checkpoint(path: str, key: str = "best_model_state_dict",
                           device: DeviceLike = None) -> SingleInputRegressor:
    """A reference regressor checkpoint (``straps_model_checkpoint.tar``)
    → the port's ResNet-18 regressor in eval mode on ``device`` (None: the
    CUDA card). The input width is read from the stem's weight."""
    dev = default_device(device)
    sd = regressor_state_dict_from_reference(
        _pick(_torch_load(path), key))
    model = SingleInputRegressor(
        in_channels=int(sd["encoder.conv.weight"].shape[1]))
    return _load_into(model, sd, path, "the regressor").to(dev).eval()


def load_relation_checkpoint(path: str, key: str = "best_model_state_dict",
                             device: DeviceLike = None,
                             relation_kwargs: Optional[dict] = None
                             ) -> PoseRelationModule:
    """A reference relation checkpoint (a dict holding ``key``, or a bare
    state dict) → the port's module in eval mode on ``device`` (None: the
    CUDA card); v0 or v1 is read from the weights unless
    ``relation_kwargs`` are given."""
    dev = default_device(device)
    sd = relation_state_dict_from_reference(
        _pick(_torch_load(path), key))
    model = (PoseRelationModule(**relation_kwargs) if relation_kwargs
             else _relation_module(sd))
    return _load_into(model, sd, path, "the relation module").to(dev).eval()
