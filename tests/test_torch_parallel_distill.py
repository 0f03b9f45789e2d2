"""The port's distillation step on a (2, 2) (data, model) grid of four
gloo CPU ranks (the dry run's grid) against the JAX package's distillation
train step, from the same state (JAX's, carried across by
``convert.train_state_from_jax``; a fresh Adam on both sides) on
tests/test_torch_distill.py's seeded batch at B = 4 (64² proxies, the
last row a masked-out copy of the third): the batch split over ``data``,
the IEF's 669 → 512 and 512 → 512 layers column-parallel over ``model``.
JAX runs its step unsharded; under GSPMD its sharded step computes the
same.

On the dry run's own batch (``entry.dryrun_batch(4)``, 256² proxies) the
BN running means of the port's one-process step are up to 3.9e-5 of
their scale from JAX's (tests/probe_distill_jax_gap.py), above this bar:
a gap of the two packages' fp32 arithmetic at that size, not of the grid
(ROADMAP.md §3). tests/test_torch_parallel_entry.py holds the grid's step
to the port's one-process step there.

The update, gathered over ``model``, is held to tests/test_torch_distill.py's
bars: the loss and each task loss within 2e-5 relative, the log-variances
within 1e-6, BN statistics within 1e-5 of their scale, parameters within
1e-6 except Adam's sign flips (at most 2·lr each, under 1% of the
scalars). Every rank reports the same global metrics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402

from test_torch_distill import (  # noqa: E402
    LOG_VAR_TOL, LR, MAX_FLIP_SHARE, PARAM_TOL, STATS_REL,
    assert_losses_agree, both_states, distill_batch, port_state_like)
from torch_parallel_harness import Ranks  # noqa: E402

B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grid_distillation_step_matches_jax(tmp_path):
    jreg, jstate, tx = both_states()
    state = port_state_like(jstate)
    batch = distill_batch(seed=0, b=B)
    ranks = Ranks("distill_grid", 4, tmp_path, state_dict={
        k: v.numpy() for k, v in state.regressor.state_dict().items()},
        log_vars={k: v.detach().numpy() for k, v in state.log_vars.items()},
        lr=LR, batch=batch)
    jstate, jm, _ = jax.jit(jdistill.make_train_step(jreg, tx))(
        jstate, jassets.synthesize_assets(),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = ranks.wait()

    for r in got:
        assert_losses_agree(r["metrics"], jm, "the (2, 2) grid's step")
        for k, v in jstate.log_vars.items():
            assert abs(float(r["log_vars"][k]) - float(v)) <= LOG_VAR_TOL, k
    flat = convert.regressor_flat_from_state_dict(
        {k: torch.from_numpy(v) for k, v in got[0]["state"].items()})
    want = convert.flatten_tree(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    assert set(flat) == set(want)
    flips = total = 0
    for k, w in want.items():
        w = np.asarray(w)
        assert flat[k].shape == w.shape, k
        gap = np.abs(flat[k] - w)
        if k.startswith("batch_stats/"):
            assert gap.max() <= STATS_REL * max(np.abs(w).max(), 1e-12), k
            continue
        assert gap.max() <= 2 * LR + PARAM_TOL, (k, gap.max())
        flips += int((gap > PARAM_TOL).sum())
        total += gap.size
    print("the (2, 2) grid's step vs JAX's: %d Adam sign flips of %d "
          "scalars" % (flips, total))
    assert flips <= MAX_FLIP_SHARE * total
