"""``scripts/train_relation_torch.py relate`` on the CPU."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_relation_torch as tr  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_relate_runs_the_evaluations(tmp_path):
    """``relate`` on the tiny tree of ``tests/test_training_driver.py:
    _dataset`` (2 games × 2 players, boxes of 2 players a scene) gives the
    numbers of ``evaluate_model`` and ``evaluate_model_relate`` run
    directly with the committed regressor and relation v0 (the port's
    relate evaluation is held to JAX's in
    ``tests/test_torch_relate_eval.py``), and writes only its record into
    ``--out-dir``."""
    from soccerplayershapepose_torch.convert import (
        load_regressor_weights, load_relation_weights)
    from soccerplayershapepose_torch.drivers import training
    from soccerplayershapepose_torch.io.formats import write_boxes
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train.distill import make_train_state
    from test_training_driver import _dataset

    tree = tmp_path / "tree"
    tree.mkdir()
    roots = _dataset(tree)
    for name, src in zip(("broad_images", "broad_proxies", "broad"), roots):
        os.symlink(src, tree / name)
    rs = np.random.RandomState(1)
    for game in ("g1", "g2"):
        os.makedirs(tree / "scenes" / game / "s1")
        xy = rs.uniform(100, 1600, (2, 2))
        write_boxes(str(tree / "scenes" / game / "s1" / "boxes.xml"),
                    np.concatenate([xy, xy + rs.uniform(40, 200, (2, 2))],
                                   -1).astype(np.float32))
    out_dir = tmp_path / "out"
    out = tr.cmd_relate(tr.parse_args(["relate", "--root", str(tree),
                                       "--out-dir", str(out_dir), "--cpu"]))
    assert os.listdir(out_dir) == ["relate_eval_v0.json"]
    with open(out_dir / "relate_eval_v0.json") as f:
        assert json.load(f)["with_relation"] == out["with_relation"]
    assets = synthesize_assets()
    state = make_train_state(load_regressor_weights(os.path.join(
        REPO, "weights", "regressor_18ch_f16.npz"), "cpu"))
    kw = dict(image_root=roots[0], proxy_root=roots[1],
              target_root=roots[2])
    assert out["without_relation"] == training.evaluate_model(
        assets, state=state, **kw)
    assert out["with_relation"] == training.evaluate_model_relate(
        assets, state=state, relation=load_relation_weights(os.path.join(
            REPO, "weights", "relation_v0.npz"), "cpu"),
        boxes_root=str(tree / "scenes"), **kw)
    assert out["without_relation"]["num_players"] == 4
