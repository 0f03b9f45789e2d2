"""A resumed run of the training driver (``scripts/
train_perception_torch.py``) against an unbroken one, on the CPU.

For each kind (ProxyNet and the detector at head width 8, the regressor;
crops of 64², frames of 64 × 96 with 2 players, B = 2; rendered through
K3's PyTorch mirror, ``test_torch_e2e_eval.fast_raster``), 4 steps taken
as two segments of 2 (return codes 10, then 0) equal 4 steps in one:
``state.npz``, ``weights_last.npz`` and every logged loss bit for bit.
Each step's batch is drawn from generators seeded by step alone
(:func:`step_seed`), so the second segment draws what the unbroken run
draws there. A third call on the finished run returns 0.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401
from test_torch_train_perception import SMALL, cpu_args  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_perception_torch as tp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(kind, ckpt, segments, steps=4):
    rcs = [tp.train_segment(cpu_args(
        [kind, "--steps", str(steps), "--segment", str(seg),
         "--log-every", "1"] + SMALL, ckpt), kind) for seg in segments]
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        state = {k: z[k] for k in z.files}
    with np.load(os.path.join(ckpt, "weights_last.npz")) as z:
        weights = {k: z[k] for k in z.files}
    with open(os.path.join(ckpt, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return rcs, state, weights, log


@pytest.mark.parametrize("kind", tp.KINDS)
def test_split_run_equals_unbroken_run(kind, fast_raster, tmp_path):
    rcs, state, weights, log = _run(kind, str(tmp_path / "one"), [4])
    assert rcs == [0]
    rcs2, state2, weights2, log2 = _run(kind, str(tmp_path / "two"), [2, 2])
    assert rcs2 == [10, 0]
    assert set(state) == set(state2) and set(weights) == set(weights2)
    assert all(np.array_equal(state[k], state2[k]) for k in state)
    assert all(np.array_equal(weights[k], weights2[k]) for k in weights)
    assert int(state["step"]) == 4 and int(state["opt_state/1/.count"]) == 4
    assert [r["step"] for r in log2] == [1, 2, 3, 4]
    for a, b in zip(log, log2):
        assert a["kind"] == kind and "steps_per_s" in a
        assert {k: v for k, v in a.items() if k != "steps_per_s"} == \
            {k: v for k, v in b.items() if k != "steps_per_s"}
        assert all(math.isfinite(v) for v in a.values()
                   if isinstance(v, float))
    # A finished run is complete, and stays as it was.
    assert tp.train_segment(cpu_args(
        [kind, "--steps", "4", "--segment", "2"] + SMALL,
        str(tmp_path / "two")), kind) == 0
