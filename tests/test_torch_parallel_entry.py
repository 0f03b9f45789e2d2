"""The port's entry points (``entry.py``, the counterpart of
``__graft_entry__.py``).

* ``dryrun_multichip(4)``: four gloo CPU ranks on a (2, 2) (data, model)
  grid run one distillation step (the batch of 4 on ``data``, the IEF's
  669 → 512 and 512 → 512 layers column-parallel on ``model``, 512 → 157
  replicated), the 2-iteration sharded fit and one sharded ProxyNet step,
  each finite. The step's update, gathered over ``model``, equals the
  unsplit one-process step on the whole batch under
  tests/test_torch_distill.py's bars: the loss and each task loss within
  2e-5 relative, the log-variances within 1e-6, BN statistics within 1e-5
  of their scale, parameters within 1e-6 except Adam's sign flips (at
  most 2·lr each, under 1% of the scalars);
* ``dryrun_multichip(8)`` on a (4, 2) grid (slow tier, as
  tests/test_entry.py's);
* ``entry(device="cpu")``: the predict slice on 32 crops of 512², its
  vertices (32, 6890, 3) and finite.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch import entry  # noqa: E402
from soccerplayershapepose_torch.smpl import load_assets  # noqa: E402
from soccerplayershapepose_torch.train import distill  # noqa: E402

LOSS_REL = 2e-5
LOG_VAR_TOL = 1e-6
PARAM_TOL = 1e-6
STATS_REL = 1e-5
MAX_FLIP_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_4_matches_the_unsplit_step(tmp_path):
    summary = entry.dryrun_multichip(4, out_dir=str(tmp_path))
    assert summary["grid"] == [2, 2]
    assert summary["split"] == ["ief.fcs.0", "ief.fcs.1"]
    assert np.isfinite(summary["fit"]["joint_err"])
    assert summary["fit"]["rows"] == 4
    assert np.isfinite(summary["perception"]["loss"])

    state = distill.make_train_state(
        distill.new_regressor(18, seed=0, device="cpu"),
        learning_rate=entry.DRYRUN_LR)
    state, metrics, _ = distill.make_train_step()(
        state, load_assets(), entry.dryrun_batch(4))
    for k, v in metrics.items():
        w = float(v)
        assert abs(summary["distill"][k] - w) <= LOSS_REL * abs(w), (k, w)
    for k, v in state.log_vars.items():
        assert abs(summary["log_vars"][k] - float(v.detach())) \
            <= LOG_VAR_TOL, k

    with np.load(tmp_path / "regressor.npz") as z:
        got = {k: z[k] for k in z.files}
    want = {k: v.detach().numpy() for k, v in
            state.regressor.state_dict().items()}
    assert set(got) == set(want)
    params = dict(state.regressor.named_parameters())
    flips = total = 0
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        gap = np.abs(got[k] - w)
        if k not in params:                  # BN running statistics
            if gap.size and w.dtype.kind == "f":
                assert gap.max() <= STATS_REL * max(np.abs(w).max(),
                                                    1e-12), k
            continue
        assert gap.max() <= 2 * entry.DRYRUN_LR + PARAM_TOL, (k, gap.max())
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    print("dry run vs the unsplit step: %d sign flips of %d scalars"
          % (flips, total))
    assert flips <= MAX_FLIP_SHARE * total


@pytest.mark.slow
def test_dryrun_multichip_8(tmp_path):
    summary = entry.dryrun_multichip(8, out_dir=str(tmp_path))
    assert summary["grid"] == [4, 2]
    assert np.isfinite(summary["distill"]["loss"])
    assert np.isfinite(summary["fit"]["joint_err"])
    assert np.isfinite(summary["perception"]["loss"])


def test_entry_gives_the_predict_slice():
    fn, args = entry.entry(device="cpu")
    with torch.no_grad():
        out = fn(*args)
    assert out.vertices.shape == (32, 6890, 3)
    assert bool(torch.isfinite(out.vertices).all())
