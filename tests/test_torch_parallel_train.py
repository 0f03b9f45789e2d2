"""Data-parallel perception steps (``train/perception.py:
shard_train_step``) on two gloo CPU ranks against the one-process step on
the whole batch and against JAX's ``shard_train_step`` on a 2-device
mesh, from JAX's fresh state carried across (``convert.
perception_state_from_jax``) on the same seeded batch of 4 (2 a rank):
ProxyNet at 128² here, the detector at 64 × 96 in
tests/test_torch_parallel_detector.py; head width 32.

Inside the sharded step batch norm normalises by the global batch, and
every loss denominator (keypoint positives, IUV-valid crops, foreground
cells, the mask mean's elements; the detector's positives and valid
boxes) is summed over the ranks before it divides, so the replicas stay
identical and equal the one-process step:

* losses within 1e-4 relative;
* BN running statistics within 3.5e-6 relative to each statistic's scale;
* parameters within 2·lr; the ones more than 1e-6 apart are Adam's sign
  flips (its first step moves a scalar by ≈ lr·sign(g), so a gradient
  component within rounding of zero can take the other sign), counted
  and held under 1% of the scalars.

JAX's sharded step is one ``jax.jit`` of the whole step, as its package
runs it (``tests/test_torch_perception_train.py`` runs JAX's losses
eagerly instead, for the 1e-5 bars there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jmake_mesh, shard_batch as jshard_batch)
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.detector import (  # noqa: E402
    PlayerDetector)
from soccerplayershapepose_torch.models.perception import ProxyNet  # noqa
from soccerplayershapepose_torch.train import perception as ttrain  # noqa

from test_torch_detector_train import frame_batch  # noqa: E402
from test_torch_perception_train import (  # noqa: E402
    CH, LR, jax_batch, jax_proxynet_state, port_state, proxynet_batch, rel,
    torch_batch)
from torch_parallel_harness import Ranks  # noqa: E402

B = 4
LOSS_REL = 1e-4
STATS_REL = 3.5e-6
PARAM_TOL = 1e-6
MAX_FLIP_SHARE = 0.01
DET_HW = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(kind):
    """(JAX model, JAX state, optimizer, port net, numpy batch)."""
    if kind == "proxynet":
        model, jstate, tx = jax_proxynet_state()
        return (model, jstate, tx, ProxyNet(channels=CH),
                proxynet_batch(5, b=B, iuv_valid=[1.0, 0.0, 1.0, 1.0]))
    model = jdet.PlayerDetector(channels=CH)
    jstate, tx = jtrain.make_detector_state(
        model, jax.random.PRNGKey(1), hw=DET_HW, learning_rate=LR)
    return model, jstate, tx, PlayerDetector(channels=CH), frame_batch(6, b=B)


def flat_state(state_dict):
    return convert.proxynet_flat_from_state_dict(
        {k: torch.as_tensor(v) for k, v in state_dict.items()})


def assert_states_agree(got, want, what):
    """Flat flax-named variables: BN statistics within STATS_REL of their
    scale, parameters within 2·lr with the flips (> PARAM_TOL) counted."""
    assert set(got) == set(want)
    flips = total = 0
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w)
        gap = np.abs(got[k] - w)
        if k.startswith("batch_stats/"):
            r = gap.max() / max(np.abs(w).max(), 1e-12)
            worst = max(worst, r)
            assert r <= STATS_REL, (what, k, r)
            continue
        assert gap.max() <= 2 * LR + PARAM_TOL, (what, k, gap.max())
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    print("%s: %d sign flips of %d scalars, BN statistics %.3g"
          % (what, flips, total, worst))
    assert flips <= MAX_FLIP_SHARE * total, (what, flips)


def sharded_step_run(kind, tmp_path):
    """(the ranks' results, the one-process step's, JAX's sharded step's)
    of one ``kind`` step; the ranks run while the test process steps."""
    jmodel, jstate, tx, net, batch = case(kind)
    state = port_state(net, jstate)
    sd = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    ranks = Ranks("perception_step", 2, tmp_path, kind=kind, state_dict=sd,
                  batch=batch, ch=CH, lr=LR)
    step = (ttrain.make_proxynet_train_step() if kind == "proxynet"
            else ttrain.make_detector_train_step())
    state, tl = step(state, torch_batch(batch))
    one = {"state": flat_state(net.state_dict()),
           "losses": {k: float(v) for k, v in tl.items()}}
    jfn = (jtrain.make_proxynet_train_step(jmodel, tx) if kind == "proxynet"
           else jtrain.make_detector_train_step(jmodel, tx))
    mesh = jmake_mesh(jax.devices("cpu")[:2])
    jnew, jl = jtrain.shard_train_step(jfn, mesh)(
        jstate, jshard_batch(jax_batch(batch), mesh))
    want_jax = {"state": convert.flatten_tree({
        "params": jax.device_get(jnew.params),
        "batch_stats": jax.device_get(jnew.batch_stats)}),
        "losses": {k: float(v) for k, v in jl.items()}}
    return ranks.wait(), one, want_jax


def check_sharded_step(kind, run):
    ranks, one, want_jax = run
    for r in ranks:
        assert r["step"] == 1 and r["count"] == 1
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    got = {"state": flat_state(ranks[0]["state"]),
           "losses": ranks[0]["losses"]}
    for who, want in (("one process", one), ("JAX", want_jax)):
        assert set(got["losses"]) == set(want["losses"])
        gaps = {k: rel(got["losses"][k], want["losses"][k])
                for k in want["losses"]}
        print(kind, "losses vs", who, gaps)
        assert max(gaps.values()) <= LOSS_REL, (who, gaps)
        assert_states_agree(got["state"], want["state"],
                            "%s vs %s" % (kind, who))


def test_sharded_proxynet_step_matches_one_process_and_jax(tmp_path):
    check_sharded_step("proxynet", sharded_step_run("proxynet", tmp_path))
