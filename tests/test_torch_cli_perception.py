"""The port's ``train-perception`` subcommand on the CPU, whose weights the
JAX package's loader reads.

* ``--model proxynet`` as a subprocess (``python -m
  soccerplayershapepose_torch``, ``--device cpu``), 2 steps of 2 crops at
  64²: one JSON line ``{"weights", "steps"}``; JAX's
  ``load_perception_weights`` reads the file, and its ProxyNet's outputs on
  a seeded crop agree with the port's loader's within 1e-4;
* ``--model detector`` in process (its 256 × 448 frames, at half the batch
  size, rendered through K3's PyTorch mirror,
  ``test_torch_e2e_eval.fast_raster``: the dense plain z-buffer at 448²
  takes minutes on the CPU), 2 steps: the same checks with JAX's
  detector;
* without ``--device cpu`` on a machine without CUDA it exits non-zero.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.detector import PlayerDetector  # noqa
from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa

from soccerplayershapepose_torch import cli, convert  # noqa: E402

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 1e-4


def run_cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "soccerplayershapepose_torch",
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    return out


def outputs_agree(got, want):
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=OUT_TOL)


def test_train_perception_proxynet_subprocess(tmp_path):
    path = str(tmp_path / "pn.npz")
    out = run_cli("train-perception", "--out", path, "--model", "proxynet",
                  "--steps", "2", "--batch-size", "2", "--wh", "64",
                  "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "weights": path, "steps": 2}
    model = JProxyNet()
    variables = jtrain.load_perception_weights(path, model, wh=64)
    port = convert.load_proxynet_weights(path, "cpu")
    image = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(image))
    with torch.no_grad():
        got = port(torch.from_numpy(image).permute(0, 3, 1, 2))
    outputs_agree(got, want)


def test_train_perception_detector_in_process(fast_raster, tmp_path,
                                              capsys):
    path = str(tmp_path / "det.npz")
    assert cli.main(["train-perception", "--out", path, "--model",
                     "detector", "--steps", "2", "--batch-size", "2",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "weights": path, "steps": 2}
    model = PlayerDetector()
    variables = jtrain.load_perception_weights(path, model, hw=(64, 96))
    port = convert.load_detector_weights(path, "cpu")
    image = np.random.RandomState(1).rand(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(image))
    with torch.no_grad():
        got = port(torch.from_numpy(image).permute(0, 3, 1, 2))
    outputs_agree(got, want)


def test_train_perception_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_cli("train-perception", "--out", str(tmp_path / "x.npz"),
                  "--steps", "1", timeout=120)
    assert out.returncode != 0
    assert not os.path.exists(str(tmp_path / "x.npz"))
