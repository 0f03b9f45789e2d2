"""The port's self-supervised step against the JAX package's: one train
step of each ``item`` (pose, shape, both) and the eval step, from JAX's
state carried across (warm-started from the committed regressor), on
B = 2 seeded proxies of 64², 512² target
silhouettes and the silhouette rendered at 32² (the target
stride-subsampled to it) at σ = 1e-4, as the trainer renders it. On the
CPU the render is the plain soft rasterizer on both sides.

JAX's steps run eagerly, not under ``jax.jit``: XLA
reassociates ``log(1 − t + 1e-6)`` into ``log((1 + 1e-6) − t)``, which at
t = 1 is log(9.54e-7) instead of log(1e-6) in fp32, and moves the jitted
silhouette loss 0.34% from the eager one (and from the same formula in
float64, which the port matches within 1e-7).

Tolerances, as ``test_torch_distill.py`` holds a step: the loss and task
losses ≤ 2e-5 relative; the joints-2D error ≤ 2e-5 relative; the
silhouette IoU equal (both round the same soft silhouette; a pixel within
rounding of 0.5 could flip it, and none does here); log-variances ≤ 1e-6;
parameters ≤ 1e-6 except Adam's sign flips (counted, ≤ 1%); BN statistics
≤ 1e-5 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import selfsup as jselfsup  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402

from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.train import selfsup as tselfsup  # noqa: E402

from test_torch_distill import (  # noqa: E402
    LOSS_REL, LOG_VAR_TOL, assert_losses_agree, assert_params_agree,
    assert_stats_agree, both_assets, both_states, carry_jax_state,
    seeded_proxies, to_torch_batch)

B, WH, RENDER_WH, LR = 2, 64, 32, 1e-3
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "regressor_18ch_f16.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def selfsup_batch(seed=0):
    """The proxy's keypoints moved a little as the joint targets, and as
    the silhouette targets upright ellipses about where the initial
    regressor puts its bodies (so the IoU is neither 0 nor 1)."""
    rs = np.random.RandomState(seed)
    _, j2d, proxy = seeded_proxies(rs, B, WH)
    j2d_t = (j2d + rs.randn(*j2d.shape).astype(np.float32) * 5)
    yy, xx = np.mgrid[:512, :512]
    c = rs.uniform(-15, 15, (B, 2)) + [270, 240]
    r = rs.uniform([30, 60], [50, 100], (B, 2))
    sil = ((((xx[None] - c[:, :1, None]) / r[:, :1, None]) ** 2
            + ((yy[None] - c[:, 1:, None]) / r[:, 1:, None]) ** 2) < 1
           ).astype(np.float32)
    return {"proxy": proxy, "silhouette": sil, "joints2d": j2d_t,
            "mask": np.ones((B,), np.float32)}


def _states(item):
    """JAX's self-supervised state warm-started from the committed
    regressor (as the trainer is; a random net in train mode puts its
    bodies off the image), and the port's carrying it."""
    jreg, jstate, tx = both_states(init=lambda r, k: jselfsup.
                                   make_selfsup_state(r, k, item, LR))
    v = jstraps.load_regressor_weights(WEIGHTS, jreg,
                                       jassets.synthesize_assets())
    jstate = jstate._replace(params=v["params"],
                             batch_stats=v["batch_stats"])
    state = tselfsup.make_selfsup_state(SingleInputRegressor(18), item, LR)
    return jreg, jstate, tx, carry_jax_state(state, jstate)


@pytest.mark.parametrize("item", ["pose", "shape", "both"])
def test_selfsup_train_step_matches_jax(item, both_assets):
    ja, ta = both_assets
    jreg, jstate, tx, state = _states(item)
    assert set(state.log_vars) == set(jstate.log_vars)
    nb = selfsup_batch(0)
    jstep = jselfsup.make_selfsup_step(jreg, tx, item, render_wh=RENDER_WH)
    jstate, jm, _ = jstep(jstate, ja, {k: jnp.asarray(v)
                                       for k, v in nb.items()})
    step = tselfsup.make_selfsup_step(item, render_wh=RENDER_WH)
    state, m, aux = step(state, ta, to_torch_batch(nb))
    assert state.step == 1
    assert_losses_agree({"loss": m["loss"], "joints2D_l2e":
                         m["joints2D_l2e"]},
                        {"loss": jm["loss"], "joints2D_l2e":
                         jm["joints2D_l2e"]}, item)
    assert float(m["silh_iou"]) == float(jm["silh_iou"])
    if item != "pose":
        assert 0.0 < float(m["silh_iou"]) < 1.0
    for k, v in jstate.log_vars.items():
        assert abs(float(state.log_vars[k].detach()) - float(v)) \
            <= LOG_VAR_TOL, k
    assert_params_agree(state, jstate, LR, "selfsup " + item)
    assert_stats_agree(state, jstate, "selfsup " + item)


def test_selfsup_eval_step_matches_jax(both_assets):
    ja, ta = both_assets
    jreg, jstate, tx, state = _states("both")
    nb = selfsup_batch(1)
    jm, _ = jselfsup.make_selfsup_step(jreg, tx, "both", RENDER_WH,
                                       train=False)(
        jstate, ja, {k: jnp.asarray(v) for k, v in nb.items()})
    before = {k: v.clone() for k, v in state.regressor.state_dict().items()}
    m, aux = tselfsup.make_selfsup_step("both", RENDER_WH, train=False)(
        state, ta, to_torch_batch(nb))
    for k, v in jm.items():
        w = float(v)
        assert abs(float(m[k]) - w) <= LOSS_REL * max(abs(w), 1e-12), k
    assert all(torch.equal(v, before[k])
               for k, v in state.regressor.state_dict().items())
    assert state.step == 0 and aux["pred_j2d"].shape == (B, 17, 2)


def test_losses_for_item():
    assert tselfsup.losses_for_item("pose") == ("joints2D",)
    assert tselfsup.losses_for_item("shape") == ("silhouette",)
    assert tselfsup.losses_for_item("both") == ("joints2D", "silhouette")
