"""Carry state from numpy into the port.

The JAX package's ``SMPLAssets`` turned into numpy
(``{k: np.asarray(v) for k, v in dataclasses.asdict(assets).items()}``) and
a fit's initial parameters become the port's tensors, so both packages can
compute on the same numbers. The committed flax regressor weights
(``weights/*.npz``, flat keys as ``train/checkpoint.py:_flatten`` writes
them) load into :class:`SingleInputRegressor`, the committed ProxyNet
weights (``weights/proxynet_*_f16.npz``) into :class:`ProxyNet`, the
detector's (``weights/detector_256x448_f16.npz``) into
:class:`PlayerDetector`, the frame classifier's
(``weights/frame_classifier.npz``) into :class:`ClassifyNet` and
:class:`FrameFeatureNet`, and the relation modules'
(``weights/relation_v{0,1}.npz``) into :class:`PoseRelationModule` at run
time. Nothing is written to disk but a
classifier bundle, in the JAX package's layout, when one is saved.

The other direction serves the trainers: the regressor's, ProxyNet's, the
detector's and the relation module's state back to flat flax names and
layouts (:func:`regressor_flat_from_state_dict`,
:func:`proxynet_flat_from_state_dict`, :func:`detector_flat_from_state_dict`,
:func:`relation_flat_from_module`), which the checkpoints and the saved
weights use, and a JAX train state's variables and Adam moments (as numpy)
into the port's trainer state (:func:`train_state_from_jax`,
:func:`perception_state_from_jax`), so both packages can train from one
point.

For a (data, model) grid, :func:`split_model_shards` cuts a full parameter
(or Adam moment) tree into one model rank's shards and
:func:`gather_model_shards` puts the ranks' shards back together, by the
rule of ``models/ief.py:splits_on_model_axis``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Mapping, Optional

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import FitInit
from soccerplayershapepose_torch.models.classifier import ClassifyNet
from soccerplayershapepose_torch.models.detector import PlayerDetector
from soccerplayershapepose_torch.models.ief import splits_on_model_axis
from soccerplayershapepose_torch.models.perception import ProxyNet
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.models.relation import PoseRelationModule
from soccerplayershapepose_torch.pipeline.classification import (
    FrameFeatureNet)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)

# flax leaf name → PyTorch parameter or buffer name
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
_FLAT_KEY = re.compile(r"^(params|batch_stats)/(\w+)/(.+)/(\w+)$")


def assets_from_numpy(d: dict, device="cpu") -> SMPLAssets:
    """dict of numpy arrays keyed like ``SMPLAssets`` → the port's assets.
    A ``parents`` entry, if present, gives the kinematic tree."""
    parents = d.get("parents", cfg.SMPL_PARENTS)
    arrays = {k: np.asarray(v) for k, v in d.items() if k != "parents"}
    return SMPLAssets.from_numpy(arrays, parents=tuple(parents), device=device)


def fit_init_from_numpy(body_pose, global_orient, betas, cam_wp,
                        device="cpu") -> FitInit:
    """(B, 23, 3, 3), (B, 1, 3, 3), (B, 10), (B, 3) arrays → ``FitInit``."""
    return FitInit(*(as_f32(np.asarray(x), device)
                     for x in (body_pose, global_orient, betas, cam_wp)))


def _module_name(top: str, path: list) -> str:
    """flax module path under ``ResNet_0`` / ``IEFModule_0`` → the
    :class:`SingleInputRegressor` submodule that holds it."""
    if top == "IEFModule_0" and len(path) == 1:
        return "ief.fcs.%d" % int(path[0].split("_")[1])      # Dense_k
    if top == "ResNet_0" and len(path) == 1:
        return {"Conv_0": "encoder.conv", "BatchNorm_0": "encoder.norm"}[
            path[0]]
    if top == "ResNet_0" and len(path) == 2:
        block = int(path[0].rsplit("_", 1)[1])   # BasicBlock_i, Bottleneck_i
        kind, j = path[1].rsplit("_", 1)
        return "encoder.blocks.%d.%s.%d" % (
            block, {"Conv": "convs", "BatchNorm": "norms"}[kind], int(j))
    raise KeyError("/".join([top] + path))


def regressor_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax variables (``params/ResNet_0/Conv_0/kernel``,
    ``batch_stats/ResNet_0/BatchNorm_0/mean``, …) → a
    :class:`SingleInputRegressor` state dict: conv kernels HWIO → OIHW,
    dense kernels (in, out) → (out, in), BN scale/bias/mean/var →
    weight/bias/running_mean/running_var, everything cast to fp32."""
    sd = {}
    for key, arr in flat.items():
        m = _FLAT_KEY.match(key)
        if m is None:
            raise KeyError("not a flat flax variable name: %r" % key)
        _, top, path, leaf = m.groups()
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        name = "%s.%s" % (_module_name(top, path.split("/")), _LEAVES[leaf])
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _load_strict(model, sd: dict, path: str, what: str):
    """Load ``sd`` into ``model``; a missing or an unexpected variable
    raises (BN's ``num_batches_tracked`` is not in flax's variables)."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError("weights %s do not fit %s: missing %s, unexpected %s"
                         % (path, what, missing[:5], unexpected[:5]))
    return model


def default_weights_path(kind: str) -> Optional[str]:
    """The committed ``weights/<kind>*_f16.npz`` at the repo root whose
    name sorts last (the highest resolution tag), or None if there is
    none (``train/perception.py:default_weights_path`` of the JAX
    package)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hits = sorted(glob.glob(os.path.join(root, "weights",
                                         f"{kind}*_f16.npz")))
    return hits[-1] if hits else None


def _read_flat(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def regressor_variables(flat: dict) -> dict:
    """A regressor npz's variables without the loss's ``log_vars/``
    collection, which a training state may carry beside the parameters
    and BN statistics; every other name stays for the strict load."""
    return {k: v for k, v in flat.items() if not k.startswith("log_vars/")}


def load_regressor_weights(path: str, device: DeviceLike = None
                           ) -> SingleInputRegressor:
    """Read a committed flax regressor npz → the regressor in eval mode on
    ``device`` (None: the CUDA card). The input width and depth are read
    from the weights (stem kernel's input channels; ``Bottleneck`` blocks
    mean ResNet-50); IEF runs 3 iterations. A ``log_vars/`` collection
    beside the variables is left out (:func:`regressor_variables`)."""
    dev = default_device(device)
    flat = regressor_variables(_read_flat(path))
    in_channels = int(flat["params/ResNet_0/Conv_0/kernel"].shape[2])
    layers = 50 if any("/Bottleneck_" in k for k in flat) else 18
    model = SingleInputRegressor(in_channels=in_channels,
                                 resnet_layers=layers)
    _load_strict(model, regressor_state_dict_from_flat(flat), path,
                 "the regressor")
    return model.to(dev).eval()


def _proxynet_module_name(top: str, path: list) -> str:
    """flax module path of a :class:`ProxyNet` or :class:`PlayerDetector`
    variable → the submodule that holds it
    (``FPNTrunk_0/trunk/BasicBlock_3/Conv_1`` →
    ``trunk.trunk.blocks.3.convs.1``, ``kp_tower/Conv_0`` →
    ``kp_tower.convs.0``, ``FPNTrunk_0/fpn/lateral2`` →
    ``trunk.fpn.lateral.2``, ``mask_up1`` → ``mask_up1``)."""
    if top == "FPNTrunk_0" and path[0] == "trunk":
        if len(path) == 2:
            return {"Conv_0": "trunk.trunk.conv",
                    "BatchNorm_0": "trunk.trunk.norm"}[path[1]]
        if len(path) == 3:
            block = int(path[1].rsplit("_", 1)[1])
            kind, j = path[2].rsplit("_", 1)
            return "trunk.trunk.blocks.%d.%s.%d" % (
                block, {"Conv": "convs", "BatchNorm": "norms"}[kind], int(j))
    if top == "FPNTrunk_0" and path[0] == "fpn" and len(path) == 2:
        m = re.fullmatch(r"(lateral|smooth)(\d+)", path[1])
        if m:
            return "trunk.fpn.%s.%d" % (m.group(1), int(m.group(2)))
    if top.endswith("_tower") and len(path) == 1:
        return "%s.convs.%d" % (top, int(path[0].split("_")[1]))
    raise KeyError("/".join([top] + path))


def proxynet_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax ProxyNet variables (``params/FPNTrunk_0/trunk/Conv_0/
    kernel``, ``params/kp_out/bias``, ``batch_stats/.../mean``, …) → a
    :class:`ProxyNet` state dict, with the mapping of
    :func:`regressor_state_dict_from_flat` (HWIO → OIHW, BN names),
    float16 cast to fp32 as flax promotes it against fp32 images."""
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if len(parts) < 3 or parts[0] not in ("params", "batch_stats") \
                or parts[-1] not in _LEAVES:
            raise KeyError("not a flat flax variable name: %r" % key)
        top, path, leaf = parts[1], parts[2:-1], parts[-1]
        name = top if not path else _proxynet_module_name(top, path)
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1)
        sd["%s.%s" % (name, _LEAVES[leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd


# ProxyNet's IUV head, which the 18-channel proxy does not use.
IUV_HEAD = ("iuv_tower", "part_out", "uv_out")


def load_proxynet_weights(path: str, device: DeviceLike = None,
                          with_iuv: Optional[bool] = None) -> ProxyNet:
    """Read a committed flax ProxyNet npz → the net in eval mode on
    ``device`` (None: the CUDA card). The head width is read from the
    weights, and ``with_iuv`` too unless given: ``with_iuv=False`` drops
    the IUV head's variables (``IUV_HEAD``) by name, as the full-frame
    pipeline builds ProxyNet. The load is strict: a missing or an
    unexpected variable raises."""
    dev = default_device(device)
    flat = _read_flat(path)
    if with_iuv is None:
        with_iuv = "params/part_out/kernel" in flat
    if not with_iuv:
        flat = {k: v for k, v in flat.items()
                if k.split("/")[1] not in IUV_HEAD}
    channels = int(flat["params/kp_out/kernel"].shape[2])
    model = ProxyNet(with_iuv=with_iuv, channels=channels)
    _load_strict(model, proxynet_state_dict_from_flat(flat), path, "ProxyNet")
    return model.to(dev).eval()


def detector_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax PlayerDetector variables (``params/FPNTrunk_0/...``,
    ``params/det_tower/Conv_{0,1}``, ``params/{center,size,offset}_out``,
    ``batch_stats/...``) → a :class:`PlayerDetector` state dict, with
    ProxyNet's mapping (the trunk's names are the same)."""
    return proxynet_state_dict_from_flat(flat)


def load_detector_weights(path: str, device: DeviceLike = None
                          ) -> PlayerDetector:
    """Read a committed flax detector npz (``weights/detector_256x448_f16
    .npz``) → the detector in eval mode on ``device`` (None: the CUDA
    card). The width is read from the weights; the load is strict."""
    dev = default_device(device)
    flat = _read_flat(path)
    channels = int(flat["params/center_out/kernel"].shape[2])
    model = PlayerDetector(channels=channels)
    _load_strict(model, detector_state_dict_from_flat(flat), path,
                 "PlayerDetector")
    return model.to(dev).eval()


def _classifier_module_name(prefix: str, top: str, path: list) -> str:
    """flax module path of a classifier bundle's variable → the
    :class:`ClassifyNet` (``head``) or :class:`FrameFeatureNet`
    (``features``) submodule that holds it: ``Dense_k`` → ``fcs.k`` in the
    head, ``Dense_0`` → ``fc`` and ``ResNet_0/...`` → ``encoder...`` (as
    the regressor's trunk) in the features."""
    if not path and top.startswith("Dense_"):
        k = int(top.split("_")[1])
        if prefix == "head":
            return "fcs.%d" % k
        if k == 0:
            return "fc"
    if prefix == "features" and top == "ResNet_0":
        return _module_name(top, path)
    raise KeyError("/".join([prefix, top] + path))


def classifier_state_dict_from_flat(flat: dict) -> dict:
    """Flat classifier bundle (``head/params/Dense_0/kernel``,
    ``features/params/ResNet_0/Conv_0/kernel``,
    ``features/batch_stats/ResNet_0/BatchNorm_0/mean``, …) →
    ``{"head": state dict, "features": state dict}`` (``features`` only
    when the bundle has them), with the regressor's mapping (HWIO → OIHW,
    (in, out) → (out, in), BN names), everything cast to fp32."""
    out = {}
    for key, arr in flat.items():
        prefix, _, rest = key.partition("/")
        m = _FLAT_KEY.match(rest) or re.match(
            r"^(params|batch_stats)/(\w+)()/(\w+)$", rest)
        if prefix not in ("head", "features") or m is None:
            raise KeyError("not a classifier bundle variable: %r" % key)
        _, top, path, leaf = m.groups()
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        name = "%s.%s" % (_classifier_module_name(
            prefix, top, path.split("/") if path else []), _LEAVES[leaf])
        out.setdefault(prefix, {})[name] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def load_classifier_weights(path: str, device: DeviceLike = None):
    """Read a classifier bundle (``weights/frame_classifier.npz``, or one
    :func:`classifier_flat_from_modules` wrote) → ``(ClassifyNet,
    FrameFeatureNet or None)`` in eval mode on ``device`` (None: the CUDA
    card). The load is strict: every variable of the bundle is used and
    every parameter and buffer of the nets is set."""
    dev = default_device(device)
    sds = classifier_state_dict_from_flat(_read_flat(path))
    if "head" not in sds:
        raise ValueError("weights %s hold no classifier head" % path)
    head = _load_strict(ClassifyNet(), sds["head"], path, "ClassifyNet")
    features = None
    if "features" in sds:
        features = _load_strict(FrameFeatureNet(), sds["features"], path,
                                "FrameFeatureNet").to(dev).eval()
    return head.to(dev).eval(), features


def _flat_name(prefix: str, name: str):
    """Inverse of :func:`_classifier_module_name` with the leaf:
    a state-dict name → its flat bundle key, or None for BN's
    ``num_batches_tracked``."""
    mod, leaf = name.rsplit(".", 1)
    if leaf == "num_batches_tracked":
        return None
    parts = mod.split(".")
    if parts[0] == "fcs":
        path = "Dense_%d" % int(parts[1])
    elif parts[0] == "fc":
        path = "Dense_0"
    else:       # encoder.conv, encoder.norm, encoder.blocks.i.*
        path = _regressor_flax_path(mod, "BasicBlock")
    is_norm = "BatchNorm" in path
    flax_leaf = {"weight": "scale" if is_norm else "kernel", "bias": "bias",
                 "running_mean": "mean", "running_var": "var"}[leaf]
    col = "batch_stats" if flax_leaf in ("mean", "var") else "params"
    return "%s/%s/%s/%s" % (prefix, col, path, flax_leaf)


def classifier_flat_from_modules(head: ClassifyNet,
                                 features: Optional[FrameFeatureNet] = None
                                 ) -> dict:
    """``head`` (and ``features``) → the flat bundle in the JAX package's
    key layout: conv kernels OIHW → HWIO, dense (out, in) → (in, out), fp32
    numpy."""
    flat = {}
    for prefix, net in (("head", head), ("features", features)):
        if net is None:
            continue
        for name, t in net.state_dict().items():
            key = _flat_name(prefix, name)
            if key is None:
                continue
            a = t.detach().cpu().to(torch.float32).numpy()
            if key.endswith("/kernel"):
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            flat[key] = np.ascontiguousarray(a)
    return flat


def relation_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax PoseRelationModule params (``params/WQ/kernel`` (in, H,
    dk), ``params/WG/kernel`` (G, H), ``params/lift``, ``params/proj_back``)
    → its state dict: each kernel reshaped to (in, out) and transposed."""
    sd = {}
    for key, arr in flat.items():
        top, name, leaf = key.split("/")
        if top != "params":
            raise ValueError("unexpected relation variable " + key)
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            sd[name + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(a.reshape(a.shape[0], -1).T))
        else:
            sd[name + ".bias"] = torch.from_numpy(a.reshape(-1).copy())
    return sd


def load_relation_weights(path: str, device: DeviceLike = None
                          ) -> PoseRelationModule:
    """Read a committed flax relation npz → the module on ``device`` (None:
    the CUDA card). v0 or v1 is read from the weights: a ``lift`` layer
    means v1; the units and their width come from ``WQ``'s kernel, the
    embedding width from ``WG``'s."""
    dev = default_device(device)
    flat = _read_flat(path)
    _, h, dk = flat["params/WQ/kernel"].shape
    lift = flat.get("params/lift/kernel")
    model = PoseRelationModule(
        n_relations=int(h), key_dim=int(dk),
        geo_dim=int(flat["params/WG/kernel"].shape[0]),
        lift_dim=None if lift is None else int(lift.shape[1]))
    _load_strict(model, relation_state_dict_from_flat(flat), path,
                 "the relation module")
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# The port's state → flat flax variables
# ---------------------------------------------------------------------------

def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested mappings of arrays (a flax variable tree, as numpy) → flat
    ``a/b/c`` names, as the JAX package's checkpoints flatten them."""
    flat = {}
    for k, v in tree.items():
        key = "%s/%s" % (prefix, k) if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.array(v)
    return flat


def _regressor_flax_path(mod: str, block: str) -> str:
    """Inverse of :func:`_module_name`: a :class:`SingleInputRegressor`
    submodule → its flax path (``encoder.blocks.3.convs.1`` →
    ``ResNet_0/BasicBlock_3/Conv_1``, ``ief.fcs.2`` → ``IEFModule_0/
    Dense_2``); ``block`` is ``BasicBlock`` or ``Bottleneck``."""
    parts = mod.split(".")
    if parts[0] == "ief":
        return "IEFModule_0/Dense_%d" % int(parts[2])
    if parts[1] == "conv":
        return "ResNet_0/Conv_0"
    if parts[1] == "norm":
        return "ResNet_0/BatchNorm_0"
    kind = {"convs": "Conv", "norms": "BatchNorm"}[parts[3]]
    return "ResNet_0/%s_%d/%s_%d" % (block, int(parts[2]), kind,
                                     int(parts[4]))


def regressor_flax_name(name: str, resnet_layers: int = 18
                        ) -> Optional[str]:
    """A :class:`SingleInputRegressor` state-dict name → its flat flax
    variable name (``encoder.blocks.3.norms.1.running_var`` →
    ``batch_stats/ResNet_0/BasicBlock_3/BatchNorm_1/var``), or None for
    BN's ``num_batches_tracked``."""
    mod, leaf = name.rsplit(".", 1)
    if leaf == "num_batches_tracked":
        return None
    path = _regressor_flax_path(
        mod, "Bottleneck" if resnet_layers == 50 else "BasicBlock")
    flax_leaf = {"weight": "scale" if "BatchNorm" in path else "kernel",
                 "bias": "bias", "running_mean": "mean",
                 "running_var": "var"}[leaf]
    col = "batch_stats" if flax_leaf in ("mean", "var") else "params"
    return "%s/%s/%s" % (col, path, flax_leaf)


def to_flax_layout(a: np.ndarray) -> np.ndarray:
    """A conv or dense weight → flax's kernel layout: OIHW → HWIO,
    (out, in) → (in, out)."""
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4
                                else a.T)


def from_flax_layout(a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_flax_layout`."""
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4
                                else a.T)


def regressor_flat_from_state_dict(sd: dict, resnet_layers: int = 18
                                   ) -> dict:
    """A :class:`SingleInputRegressor` state dict (or any subset of its
    names) → flat flax variables (``params/ResNet_0/Conv_0/kernel``,
    ``batch_stats/ResNet_0/BatchNorm_0/mean``, …) as fp32 numpy, in the
    dict's order: the inverse of :func:`regressor_state_dict_from_flat`
    (:func:`regressor_flax_name`, kernels :func:`to_flax_layout`)."""
    flat = {}
    for name, t in sd.items():
        key = regressor_flax_name(name, resnet_layers)
        if key is None:
            continue
        # A copy: on the CPU ``numpy()`` would share the live tensor.
        a = t.detach().cpu().to(torch.float32).numpy().copy()
        flat[key] = to_flax_layout(a) if key.endswith("/kernel") else a
    return flat


def relation_flat_from_module(module: PoseRelationModule) -> dict:
    """A :class:`PoseRelationModule` → its flat flax params
    (``params/WQ/kernel`` (in, H, dk), ``params/WG/kernel`` (G, H),
    ``params/lift``/``proj_back`` (in, out)) as fp32 numpy: the inverse of
    :func:`relation_state_dict_from_flat`."""
    h, dk = module.n_relations, module.key_dim
    flat = {}
    for name, t in module.state_dict().items():
        layer, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().to(torch.float32).numpy().copy()
        heads = {"WQ": (h, dk), "WK": (h, dk), "WV": (h, dk), "WG": (h,)}
        if leaf == "weight":
            a = a.T
            if layer in heads:
                a = a.reshape((a.shape[0],) + heads[layer])
            flat["params/%s/kernel" % layer] = np.ascontiguousarray(a)
        else:
            if layer in heads:
                a = a.reshape(heads[layer])
            flat["params/%s/bias" % layer] = np.ascontiguousarray(a)
    return flat


@torch.no_grad()
def train_state_from_jax(state, params: Mapping, batch_stats: Mapping,
                         log_vars: Mapping):
    """Copy a JAX ``TrainState``'s ``params``, ``batch_stats`` and
    ``log_vars`` (variable trees as numpy) into the port's trainer
    ``state`` (``train/distill.py:TrainState``) in place: the regressor's
    parameters and BN statistics and the criterion's log-variances. The
    optimizer's moments are left as they are. Returns ``state``."""
    flat = flatten_tree({"params": params, "batch_stats": batch_stats})
    _load_strict(state.regressor, regressor_state_dict_from_flat(flat),
                 "a JAX TrainState", "the regressor")
    for k, v in log_vars.items():
        state.log_vars[k].copy_(torch.as_tensor(np.array(v, np.float32)))
    return state


def _proxynet_flax_path(mod: str) -> str:
    """Inverse of :func:`_proxynet_module_name`: a :class:`ProxyNet` or
    :class:`PlayerDetector` submodule → its flax path
    (``trunk.trunk.blocks.3.convs.1`` → ``FPNTrunk_0/trunk/BasicBlock_3/
    Conv_1``, ``trunk.fpn.lateral.2`` → ``FPNTrunk_0/fpn/lateral2``,
    ``kp_tower.convs.0`` → ``kp_tower/Conv_0``, ``kp_out`` → ``kp_out``)."""
    parts = mod.split(".")
    if parts[0] == "trunk" and parts[1] == "trunk":
        if parts[2] in ("conv", "norm"):
            return "FPNTrunk_0/trunk/" + {"conv": "Conv_0",
                                          "norm": "BatchNorm_0"}[parts[2]]
        kind = {"convs": "Conv", "norms": "BatchNorm"}[parts[4]]
        return "FPNTrunk_0/trunk/BasicBlock_%d/%s_%d" % (
            int(parts[3]), kind, int(parts[5]))
    if parts[0] == "trunk" and parts[1] == "fpn":
        return "FPNTrunk_0/fpn/%s%d" % (parts[2], int(parts[3]))
    if len(parts) == 3 and parts[1] == "convs":
        return "%s/Conv_%d" % (parts[0], int(parts[2]))
    if len(parts) == 1:
        return parts[0]
    raise KeyError(mod)


def perception_flax_name(name: str) -> Optional[str]:
    """A :class:`ProxyNet` or :class:`PlayerDetector` state-dict name → its
    flat flax variable name (``trunk.trunk.norm.running_mean`` →
    ``batch_stats/FPNTrunk_0/trunk/BatchNorm_0/mean``), or None for BN's
    ``num_batches_tracked``."""
    mod, leaf = name.rsplit(".", 1)
    if leaf == "num_batches_tracked":
        return None
    path = _proxynet_flax_path(mod)
    flax_leaf = {"weight": "scale" if "BatchNorm" in path else "kernel",
                 "bias": "bias", "running_mean": "mean",
                 "running_var": "var"}[leaf]
    col = "batch_stats" if flax_leaf in ("mean", "var") else "params"
    return "%s/%s/%s" % (col, path, flax_leaf)


def proxynet_flat_from_state_dict(sd: dict) -> dict:
    """A :class:`ProxyNet` state dict → flat flax variables as fp32 numpy:
    the inverse of :func:`proxynet_state_dict_from_flat`
    (:func:`perception_flax_name`, kernels OIHW → HWIO)."""
    flat = {}
    for name, t in sd.items():
        key = perception_flax_name(name)
        if key is None:
            continue
        a = t.detach().cpu().to(torch.float32).numpy().copy()
        flat[key] = to_flax_layout(a) if key.endswith("/kernel") else a
    return flat


def detector_flat_from_state_dict(sd: dict) -> dict:
    """A :class:`PlayerDetector` state dict → flat flax variables: the
    inverse of :func:`detector_state_dict_from_flat`."""
    return proxynet_flat_from_state_dict(sd)


@torch.no_grad()
def perception_state_from_jax(state, params: Mapping, batch_stats: Mapping,
                              opt_state=None):
    """Copy a JAX perception train state (``params``, ``batch_stats`` and
    optax's Adam state, as numpy) into the port's ``state``
    (``train/perception.py:PerceptionTrainState``) in place: the net's
    parameters and BN statistics, and with ``opt_state`` (optax's
    ``(ScaleByAdamState, EmptyState)`` or the ``ScaleByAdamState``) Adam's
    moments and count. Returns ``state``."""
    model = state.model
    flat = flatten_tree({"params": params, "batch_stats": batch_stats})
    _load_strict(model, proxynet_state_dict_from_flat(flat),
                 "a JAX perception state", type(model).__name__)
    if opt_state is None:
        return state
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    names = [perception_flax_name(n)[len("params/"):]
             for n, _ in model.named_parameters()]
    for moments, tree in ((state.opt.mu, adam.mu), (state.opt.nu, adam.nu)):
        mflat = flatten_tree(tree)
        for key, m in zip(names, moments):
            a = np.array(mflat[key], np.float32)
            if key.endswith("/kernel"):
                a = from_flax_layout(a)
            m.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(
                m.shape))
    state.opt.count = int(np.asarray(adam.count))
    return state


# ---------------------------------------------------------------------------
# Model-parallel shards of a parameter tree
# ---------------------------------------------------------------------------

def split_model_shards(tree: Mapping, n_model: int, index: int) -> dict:
    """A full {name: tensor} tree (torch layout: parameters, or Adam
    moments keyed by their parameter) → rank ``index``'s shards on a model
    axis of ``n_model``: each tensor that splits
    (``models/ief.py:splits_on_model_axis``) cut to its rows [index·k,
    (index+1)·k) of the output dimension, the rest as it is."""
    out = {}
    for k, t in tree.items():
        if splits_on_model_axis(tuple(t.shape), n_model):
            rows = t.shape[0] // n_model
            t = t[index * rows:(index + 1) * rows]
        out[k] = t
    return out


def gather_model_shards(shards, full_shapes: Mapping) -> dict:
    """The model ranks' shard trees (in rank order) → the full tree:
    each tensor whose full shape (``full_shapes[name]``) splits is
    concatenated along its output dimension, the rest taken from rank 0."""
    shards = list(shards)
    out = {}
    for k, t in shards[0].items():
        if splits_on_model_axis(tuple(full_shapes[k]), len(shards)):
            out[k] = torch.cat([s[k] for s in shards], dim=0)
        else:
            out[k] = t
    return out
