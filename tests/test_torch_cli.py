"""The port's command line (``python -m soccerplayershapepose_torch``)
against the JAX package's and its own in-process stages.

The front end's subcommands (``harvest-frames``, ``crop-broad-player``,
``detect-players`` and ``crop-player``) exit non-zero without
``--device cpu`` where there is no card, and write nothing;
tests/test_torch_cli_front.py holds their output against the JAX
package's CLI.

Each run is a subprocess whose imports refuse ``jax``, ``flax``,
``optax`` and ``soccerplayershapepose_tpu`` (the guard of
tests/test_torch_package.py): ``calc-metrics`` prints the JSON of JAX's
``calc_metrics`` on the same tree; ``single-view --device cpu`` on a tiny
tree (one player, two views, 512² proxies, joints-only, 2 iterations)
prints the JSON of the in-process ``single_view_optimization`` with the
same configuration, and writes the same files; a usage error, a
``--checkpoint`` that is no checkpoint (the import,
``io/torch_import.py``, refuses it) or no file, and the default
``--device cuda`` without a card exit non-zero and print no result.
``--checkpoint`` on a reference-named ``.tar`` predicts what the
in-process stage predicts from the imported regressor (the same files,
byte for byte); ``train --device cpu`` on a tiny tree prints its JSON line,
and ``--resume`` continues the epoch counter.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import formats as jio  # noqa: E402

from soccerplayershapepose_torch import config as cfg  # noqa: E402
from soccerplayershapepose_torch.convert import (  # noqa: E402
    default_weights_path, load_regressor_weights)
from soccerplayershapepose_torch.drivers import stages as tst  # noqa: E402
from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.pipeline.predict import (  # noqa: E402
    predict_smpl)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

from test_torch_scene_tree import tree_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GUARD = r"""
import importlib.abc, runpy, sys
REFUSED = ("jax", "jaxlib", "flax", "optax", "soccerplayershapepose_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["soccerplayershapepose_torch"] + sys.argv[1:]
runpy.run_module("soccerplayershapepose_torch", run_name="__main__")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cli(*args, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run([sys.executable, "-c", _GUARD, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def last_json(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    for v in range(2):
        img = root / "images" / "g1" / "s1" / "2"
        prx = root / "proxies" / "g1" / "s1" / "2"
        os.makedirs(img, exist_ok=True)
        os.makedirs(prx, exist_ok=True)
        open(img / f"view{v}.png", "wb").close()
        np.save(prx / f"view{v}_sil.npy",
                (rng.rand(512, 512) > 0.9).astype(np.uint8))
        jio.write_joints2d(str(prx / f"view{v}_j2d.xml"), np.concatenate(
            [rng.uniform(100, 400, (17, 2)), np.ones((17, 1))], axis=1))
    return root


def test_cli_calc_metrics_matches_jax(tmp_path):
    for player, err in (("2", 12.0), ("3", 4.5)):
        d = tmp_path / "g1" / "s1" / player
        os.makedirs(d)
        jio.write_metrics(str(d / "metrics.xml"), 0.7, err)
    for thresh in (None, "5.0"):
        extra = () if thresh is None else ("--score-thresh", thresh)
        got = last_json(run_cli("calc-metrics", "--root", str(tmp_path),
                                *extra))
        want = jio.calc_metrics(str(tmp_path), cfg.REFINE_SCORE_THRESH
                                if thresh is None else float(thresh))
        assert got == want
    assert got["num_flagged_for_refine"] == 1


def test_cli_usage_error():
    out = run_cli("single-view")
    assert out.returncode != 0
    assert "--image-root" in out.stderr
    out = run_cli("train")
    assert out.returncode != 0 and "--image-root" in out.stderr
    out = run_cli("train-perception")
    assert out.returncode != 0 and "--out" in out.stderr


def test_cli_single_view_on_cpu_matches_in_process(tmp_path, tiny_tree):
    common = ["--image-root", str(tiny_tree / "images"),
              "--proxy-root", str(tiny_tree / "proxies")]
    out = run_cli("single-view", *common, "--result-root",
                  str(tmp_path / "cli"), "--device", "cpu", "--iters", "2",
                  "--no-silhouette", "--batch-size", "2")
    got = last_json(out)
    assert "regressor weights:" in out.stdout
    model = load_regressor_weights(default_weights_path("regressor"), "cpu")
    want = tst.single_view_optimization(
        synthesize_assets(), str(tiny_tree / "images"),
        str(tiny_tree / "proxies"), str(tmp_path / "lib"),
        regressor_fn=lambda a, s, j: predict_smpl(model, a, s, j,
                                                  device="cpu"),
        fit_cfg=FitConfig(iters=2, lr=cfg.FITTING_LR, use_silhouette=False,
                          silhouette_metrics=False),
        batch_size=2, verbose=False, device="cpu")
    assert got == json.loads(json.dumps(want))
    assert got["count"] == 2
    files = tree_files(tmp_path / "cli")
    assert files == tree_files(tmp_path / "lib") == [
        "g1/s1/2/metrics.xml", "g1/s1/2/view0.npz", "g1/s1/2/view1.npz"]
    for f in files:
        with open(tmp_path / "cli" / f, "rb") as a, \
                open(tmp_path / "lib" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_cli_refuses_a_checkpoint_and_a_missing_card(tmp_path, tiny_tree):
    common = ["--image-root", str(tiny_tree / "images"),
              "--proxy-root", str(tiny_tree / "proxies"),
              "--result-root", str(tmp_path / "out")]
    ckpt = tmp_path / "straps.tar"
    ckpt.write_bytes(b"not a checkpoint")
    out = run_cli("predict", *common, "--device", "cpu",
                  "--checkpoint", str(ckpt))
    assert out.returncode != 0 and "io/torch_import.py" in out.stderr
    assert '"views"' not in out.stdout
    out = run_cli("predict", *common, "--device", "cpu",
                  "--checkpoint", str(tmp_path / "missing.tar"))
    assert out.returncode != 0 and "no such file" in out.stderr
    for argv in (["predict", *common],
                 ["create-proxy", "--image-root", str(tiny_tree / "images"),
                  "--proxy-root", str(tmp_path / "proxies")]):
        out = run_cli(*argv, cuda_visible="")
        assert out.returncode != 0 and "CUDA" in out.stderr
        assert '"views"' not in out.stdout and '"written"' not in out.stdout
    assert not (tmp_path / "out").exists()



def front_argv(name, root, out):
    """The argv of a detection subcommand over the trees under ``root``
    (tests/test_torch_cli_front.py:front_inputs)."""
    det = ["--height", "128", "--width", "192", "--score-thresh", "1e-3"]
    return {
        "crop-broad-player": ["crop-broad-player", "--frame-root",
                              str(root / "frames"), "--box-root",
                              str(out / "boxes"), "--player-root",
                              str(out / "players"), *det],
        "detect-players": ["detect-players", "--frame-root",
                           str(root / "frames"), "--out-root",
                           str(out / "det"), *det],
        "crop-player": ["crop-player", "--image-root", str(root / "views"),
                        "--out-root", str(out / "crops"), "--save-mid",
                        *det]}[name]

@pytest.mark.parametrize("name", ["harvest-frames", "crop-broad-player",
                                  "detect-players", "crop-player"])
def test_cli_front_end_refuses_a_missing_card(tmp_path, name):
    argv = (["harvest-frames", "--video", str(tmp_path / "none.avi"),
             "--out-root", str(tmp_path / "out")]
            if name == "harvest-frames"
            else front_argv(name, tmp_path, tmp_path / "out"))
    out = run_cli(*argv, cuda_visible="")
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not out.stdout.strip().startswith("{")
    assert not (tmp_path / "out").exists()


def test_cli_predict_with_a_reference_checkpoint(tmp_path, tiny_tree):
    from soccerplayershapepose_torch.io.torch_import import (
        load_straps_checkpoint)
    from test_torch_torch_import import reference_regressor_state_dict
    ckpt = str(tmp_path / "straps.tar")
    torch.save({"best_model_state_dict": reference_regressor_state_dict(3)},
               ckpt)
    common = ["--image-root", str(tiny_tree / "images"),
              "--proxy-root", str(tiny_tree / "proxies")]
    out = run_cli("predict", *common, "--result-root", str(tmp_path / "cli"),
                  "--device", "cpu", "--checkpoint", ckpt)
    assert last_json(out) == {"views": 2}
    assert "regressor weights: " + ckpt in out.stdout
    model = load_straps_checkpoint(ckpt, device="cpu")
    tst.predict_stage(synthesize_assets(), str(tiny_tree / "proxies"),
                      str(tiny_tree / "images"), str(tmp_path / "lib"),
                      regressor_fn=lambda a, s, j: predict_smpl(
                          model, a, s, j, device="cpu"), device="cpu")
    files = tree_files(tmp_path / "cli")
    assert files == tree_files(tmp_path / "lib") and len(files) == 2
    for f in files:
        with open(tmp_path / "cli" / f, "rb") as a, \
                open(tmp_path / "lib" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_cli_train_on_cpu_and_resume(tmp_path):
    from test_training_driver import _dataset
    image_root, proxy_root, target_root = _dataset(tmp_path)
    argv = ["train", "--image-root", image_root, "--proxy-root", proxy_root,
            "--target-root", target_root, "--checkpoint-dir",
            str(tmp_path / "ckpt")]
    out = run_cli(*argv, cuda_visible="")
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not (tmp_path / "ckpt").exists()
    argv += ["--device", "cpu"]
    got = last_json(run_cli(*argv, "--epochs", "1"))
    assert got["best_epoch"] == 1
    assert set(got["best_val"]) == {"pves_pa", "mpjpes_pa"}
    got = last_json(run_cli(*argv, "--epochs", "2", "--resume"))
    assert set(got) == {"best_epoch", "best_val"}
    with open(tmp_path / "ckpt" / "latest" / "meta.json") as f:
        assert json.load(f)["epoch"] == 2
