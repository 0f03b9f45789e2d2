"""The port's folder-tree training driver against the JAX package's, on
the tiny tree of ``tests/test_training_driver.py:_dataset`` (2 games × 1
scene × 2 players, 512² proxies, pseudo-GT fits).

* ``gather_scene_batches``: every array equal, bit for bit, and the same
  games, scenes, counts and masks;
* ``train_regressor``: 1 epoch, then ``resume`` to a 2nd: the epoch counter
  continues, every tracked metric is finite, ``latest/`` is written;
* ``evaluate_model`` with the committed regressor
  (``weights/regressor_18ch_f16.npz``) in both packages: each metric
  ≤ 1e-4 relative (fp32 convolutions and Procrustes in another order);
* ``read_train_split`` reads the JSON list.

``evaluate_model_relate`` is held in ``test_torch_relate_eval.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.drivers import training as jtraining  # noqa: E402,E501
from soccerplayershapepose_tpu.io import write_json_xml  # noqa: E402
from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402

from soccerplayershapepose_torch.convert import (  # noqa: E402
    load_regressor_weights)
from soccerplayershapepose_torch.drivers import training as ttraining  # noqa: E402,E501
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import distill as tdistill  # noqa: E402

from test_training_driver import _dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
MAX_PLAYERS = 3
METRIC_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("tree"))


def committed_states():
    """JAX's train state and the port's with the committed regressor."""
    jreg = JRegressor(in_channels=18)
    jstate, _ = jdistill.make_train_state(jreg, jax.random.PRNGKey(0))
    v = jstraps.load_regressor_weights(WEIGHTS, jreg,
                                       jassets.synthesize_assets())
    jstate = jstate._replace(params=v["params"],
                             batch_stats=v["batch_stats"])
    state = tdistill.make_train_state(load_regressor_weights(WEIGHTS, "cpu"))
    return jstate, state


def assert_metrics_agree(got, want, what):
    assert set(got) == set(want) and got["num_players"] == \
        want["num_players"]
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            for k in want if k != "num_players"}
    print("%s: max relative gap %.3g" % (what, max(gaps.values())))
    assert max(gaps.values()) <= METRIC_REL, (what, gaps)


def test_gather_scene_batches_matches_jax(tree):
    want = jtraining.gather_scene_batches(*tree, max_players=MAX_PLAYERS)
    got = ttraining.gather_scene_batches(*tree, max_players=MAX_PLAYERS)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k]), k
            else:
                assert g[k] == w[k], k
        assert g["num_real"] == 2 and g["mask"].tolist() == [1, 1, 0]


def test_train_regressor_and_resume(tmp_path, tree):
    assets = synthesize_assets()
    ckpt = str(tmp_path / "ckpt")
    kw = dict(max_players=MAX_PLAYERS, train_games=["g1"], device="cpu",
              log_path=str(tmp_path / "tracker.pkl"))
    out = ttraining.train_regressor(assets, *tree, ckpt, epochs=1, **kw)
    assert out["best_epoch"] == 1 and out["state"].step == 1
    assert len(out["history"]["train_losses"]) == 1
    assert os.path.isfile(os.path.join(ckpt, "latest", "params.npz"))
    out2 = ttraining.train_regressor(assets, *tree, ckpt, epochs=2,
                                     resume=True, **kw)
    assert out2["state"].step == 2
    for k, v in out2["history"].items():
        assert len(v) == 2 and np.isfinite(v).all(), k
    assert out2["history"]["train_losses"][0] == \
        out["history"]["train_losses"][0]


def test_evaluate_model_matches_jax(tree):
    jstate, state = committed_states()
    want = jtraining.evaluate_model(jassets.synthesize_assets(), *tree,
                                    jstate, max_players=MAX_PLAYERS)
    got = ttraining.evaluate_model(synthesize_assets(), *tree, state,
                                   max_players=MAX_PLAYERS)
    assert got["num_players"] == 4
    assert_metrics_agree(got, want, "evaluate_model")


def test_read_train_split(tmp_path):
    p = str(tmp_path / "train_set.xml")
    write_json_xml(p, ["g1", "g3"])
    assert ttraining.read_train_split(p) == ["g1", "g3"]


def test_model_utils_match_jax(tmp_path, tree):
    from soccerplayershapepose_tpu.utils import model_utils as jmu
    from soccerplayershapepose_torch.utils import model_utils as tmu
    for g in ("g1", "g2", "g3", "g4", "g5"):
        os.makedirs(tmp_path / "data" / g)
    want = jmu.random_select_train_set(str(tmp_path / "data"),
                                       str(tmp_path / "j.xml"), seed=3)
    got = tmu.random_select_train_set(str(tmp_path / "data"),
                                      str(tmp_path / "t.xml"), seed=3)
    assert got == want and len(got) == 4
    with open(tmp_path / "j.xml") as a, open(tmp_path / "t.xml") as b:
        assert a.read() == b.read()
    jstate, state = committed_states()
    assert tmu.count_parameters(state.regressor) == jmu.count_parameters(
        jstate.params) == tmu.count_parameters(
            convert_flat(jstate.params))


def convert_flat(params):
    from soccerplayershapepose_torch.convert import flatten_tree
    return flatten_tree(jax.device_get(params))
