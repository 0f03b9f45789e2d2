"""The port's ``evaluate_model_relate`` against the JAX package's, on the
tiny tree of ``tests/test_training_driver.py:_dataset`` with the committed
regressor and relation v0 (``weights/relation_v0.npz``), boxes from a
``<boxes_root>/<game>/<scene>/boxes.xml`` tree (2 boxes a scene, padded
with [0, 0, 1, 1] to 3 slots), with and without ``optimize_cam`` (the
50-iteration joints-only broadcast fit of [orient, camera]).

Tolerance: each metric ≤ 1e-5 relative, with the fit and without it
(measured: 1.5e-7 and 4.7e-7; fp32 on both sides). Random relation weights are refused unless
asked for, and then drawn from the given generator.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.drivers import training as jtraining  # noqa: E402,E501
from soccerplayershapepose_tpu.io import write_boxes  # noqa: E402
from soccerplayershapepose_tpu.models.relation import (  # noqa: E402
    PoseRelationModule as JRelation)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import relation as jrelation  # noqa: E402,E501

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.drivers import training as ttraining  # noqa: E402,E501
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

from test_torch_training_driver import (  # noqa: E402
    MAX_PLAYERS, REPO, committed_states)
from test_training_driver import _dataset  # noqa: E402

REL_WEIGHTS = os.path.join(REPO, "weights", "relation_v0.npz")
REL = {False: 1e-5, True: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("relate")
    tree = _dataset(root)
    boxes = str(root / "scenes")
    rs = np.random.RandomState(1)
    for game in ("g1", "g2"):
        os.makedirs(os.path.join(boxes, game, "s1"))
        xy = rs.uniform(100, 1600, (2, 2))
        write_boxes(os.path.join(boxes, game, "s1", "boxes.xml"),
                    np.concatenate([xy, xy + rs.uniform(40, 200, (2, 2))],
                                   -1).astype(np.float32))
    return tree, boxes, committed_states()


@pytest.mark.parametrize("optimize_cam", [False, True])
def test_evaluate_model_relate_matches_jax(setup, optimize_cam):
    tree, boxes, (jstate, state) = setup
    jparams = jrelation.load_relation_weights(REL_WEIGHTS, JRelation(),
                                              n_players=MAX_PLAYERS)
    want = jtraining.evaluate_model_relate(
        jassets.synthesize_assets(), *tree, jstate, relation_params=jparams,
        boxes_root=boxes, optimize_cam=optimize_cam, max_players=MAX_PLAYERS)
    got = ttraining.evaluate_model_relate(
        synthesize_assets(), *tree, state,
        relation=convert.load_relation_weights(REL_WEIGHTS, "cpu"),
        boxes_root=boxes, optimize_cam=optimize_cam, max_players=MAX_PLAYERS)
    assert set(got) == set(want) and got["num_players"] == 4
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            for k in want if k != "num_players"}
    print("relate optimize_cam=%s: max relative gap %.3g"
          % (optimize_cam, max(gaps.values())))
    assert max(gaps.values()) <= REL[optimize_cam], gaps


def test_random_relation_weights_are_opt_in(setup):
    tree, boxes, (_, state) = setup
    with pytest.raises(ValueError, match="trained relation weights"):
        ttraining.evaluate_model_relate(synthesize_assets(), *tree, state,
                                        max_players=MAX_PLAYERS)
    out = [ttraining.evaluate_model_relate(
        synthesize_assets(), *tree, state, max_players=MAX_PLAYERS,
        allow_random_init=True, gen=torch.Generator().manual_seed(7))
        for _ in range(2)]
    assert out[0] == out[1] and np.isfinite(out[0]["pves"])
