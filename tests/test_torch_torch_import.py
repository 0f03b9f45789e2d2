"""The port's import of the reference's PyTorch checkpoints against the
JAX package's: a reference-named state dict (seeded random values in the
reference modules' names and shapes) through JAX's ``io/torch_import.py``
and then ``convert.regressor_state_dict_from_flat`` /
``relation_state_dict_from_flat`` must equal the port's direct renaming,
bit for bit, for the regressor and for relation v0 and v1; the ``.tar``
loaders read such a file with ``weights_only=True`` into modules that hold
exactly those numbers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import torch_import as jimport  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.io import torch_import as timport  # noqa: E402
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)


def reference_regressor_state_dict(seed=0, in_channels=18):
    """The reference SingleInputRegressor's names and shapes (torchvision
    ResNet-18 ``image_encoder``, IEF ``ief_module``), seeded values."""
    port = SingleInputRegressor(in_channels=in_channels).state_dict()
    names = {"encoder.conv": "image_encoder.conv1",
             "encoder.norm": "image_encoder.bn1"}
    for i in range(8):
        pre = "image_encoder.layer%d.%d." % (i // 2 + 1, i % 2)
        for j, (c, n) in enumerate((("conv1", "bn1"), ("conv2", "bn2"),
                                    ("downsample.0", "downsample.1"))):
            names["encoder.blocks.%d.convs.%d" % (i, j)] = pre + c
            names["encoder.blocks.%d.norms.%d" % (i, j)] = pre + n
    for k in range(3):
        names["ief.fcs.%d" % k] = "ief_module.fc%d" % (k + 1)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in port.items():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            sd[names[mod] + "." + leaf] = torch.tensor(7)
        elif leaf == "running_var":
            sd[names[mod] + "." + leaf] = torch.rand(t.shape, generator=gen)
        else:
            sd[names[mod] + "." + leaf] = torch.randn(t.shape, generator=gen)
    return sd


def reference_relation_state_dict(v1, seed=0):
    h, dk, g, f = (16, 64, 64, 1024) if v1 else (27, 8, 8, 216)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    pre = "relation_module.relation."
    for i in range(h):
        for name, shape in (("WK", (dk, f)), ("WQ", (dk, f)),
                            ("WV", (dk, f)), ("WG", (1, g))):
            sd[f"{pre}{i}.{name}.weight"] = torch.randn(shape, generator=gen)
            sd[f"{pre}{i}.{name}.bias"] = torch.randn(shape[:1],
                                                      generator=gen)
    if v1:
        for name, shape in (("fc1", (1024, 216)), ("fc2", (216, 1024))):
            sd[name + ".weight"] = torch.randn(shape, generator=gen)
            sd[name + ".bias"] = torch.randn(shape[:1], generator=gen)
    return sd


def _via_jax_regressor(sd):
    v = jimport.convert_regressor_state_dict(sd)
    return convert.regressor_state_dict_from_flat(convert.flatten_tree(
        {k: {kk: np.asarray(vv) for kk, vv in convert.flatten_tree(
            v[k]).items()} for k in v}))


def test_regressor_import_matches_jax_route(tmp_path):
    sd = reference_regressor_state_dict()
    want = _via_jax_regressor(sd)
    got = timport.regressor_state_dict_from_reference(sd)
    got = {k: v for k, v in got.items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    path = str(tmp_path / "straps.tar")
    torch.save({"epoch": 3, "best_model_state_dict": sd}, path)
    model = timport.load_straps_checkpoint(path, device="cpu")
    assert not model.training
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("v1", [False, True])
def test_relation_import_matches_jax_route(tmp_path, v1):
    sd = reference_relation_state_dict(v1)
    v = jimport.convert_relation_state_dict(sd)
    want = convert.relation_state_dict_from_flat(
        convert.flatten_tree({"params": {
            k: {kk: np.asarray(vv) for kk, vv in d.items()}
            for k, d in v["params"].items()}}))
    got = timport.relation_state_dict_from_reference(sd)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    path = str(tmp_path / "relation.tar")
    torch.save(sd, path)     # a bare state dict
    model = timport.load_relation_checkpoint(path, device="cpu")
    assert model.lift_dim == (1024 if v1 else None)
    for k, val in want.items():
        assert torch.equal(model.state_dict()[k], val), k


def test_a_foreign_state_dict_is_refused():
    with pytest.raises(KeyError):
        timport.regressor_state_dict_from_reference(
            {"backbone.conv1.weight": torch.zeros(1)})
    with pytest.raises(ValueError):
        timport.relation_state_dict_from_reference({"fc1.weight":
                                                    torch.zeros(1)})
