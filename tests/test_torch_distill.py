"""The port's distillation train and eval steps against the JAX package's,
from JAX's state carried across before each step (``convert.
train_state_from_jax`` and Adam's moments) on the same seeded batch: B = 3
proxies of 64² built as the drivers build them (elliptic silhouettes and
the keypoints' heatmaps; the last row the second repeated and masked out,
as the drivers pad) and a learning rate of 1e-3.

Proxies of uniform noise are no test of a train step: every row is then
alike to the network, the last stage's batch variance (12 samples) is near
zero, and batch norm's backward amplifies fp32 rounding: the port's own
fp32 gradients are 3.4% (relative L2) from its fp64 ones there, against
5e-6 on these proxies.

* the loss and each task loss of both train steps and of the eval step:
  ≤ 2e-5 relative (fp32 convolutions in another order);
* the log-variances after each step: ≤ 1e-6 absolute;
* the parameters after each step: ≤ 1e-6 absolute, except Adam's sign
  flips. Adam's first step moves each scalar by lr·g/(|g| + ε) ≈
  lr·sign(g), so a gradient component within rounding of zero can take the
  other sign in the other framework and end 2·lr·k apart (k steps
  flipped). Every gap above 1e-6 must be such a flip; they are counted,
  printed and held to ≤ 1% of the scalars;
* the BN running statistics after each step: ≤ 1e-5 relative to the
  statistic's scale. PyTorch's own train-mode update would take the
  unbiased batch variance, n/(n−1) = 8/7 at this shape's last stage
  (2 × 2 maps, 3 rows, 12 samples: 9%), which this check catches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)
from soccerplayershapepose_tpu.ops.rotations import (  # noqa: E402
    batch_rodrigues as j_rodrigues)
from soccerplayershapepose_tpu.pipeline import proxy as jproxy  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import checkpoint as tckpt  # noqa: E402
from soccerplayershapepose_torch.train import distill as tdistill  # noqa: E402

B, WH, LR = 3, 64, 1e-3
LOSS_REL = 2e-5
LOG_VAR_TOL = 1e-6
PARAM_TOL = 1e-6
STATS_REL = 1e-5
MAX_FLIP_SHARE = 0.01
FLIP_MU_SHARE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_proxies(rs, b, wh):
    """(B, 512, 512) elliptic silhouettes, (B, 17, 2) keypoints in 512 px
    and their 18-channel proxy at ``wh`` (JAX's proxy function, NHWC)."""
    j2d = rs.uniform(150, 350, (b, 17, 2)).astype(np.float32)
    yy, xx = np.mgrid[:512, :512]
    c = rs.uniform(180, 330, (b, 2))
    r = rs.uniform(60, 140, (b, 2))
    sil = ((((xx[None] - c[:, :1, None]) / r[:, :1, None]) ** 2
            + ((yy[None] - c[:, 1:, None]) / r[:, 1:, None]) ** 2) < 1
           ).astype(np.float32)
    proxy = np.array(jproxy.create_proxy_representation(
        jnp.asarray(sil), jnp.asarray(j2d), out_wh=wh))
    return sil, j2d, proxy


def distill_batch(seed=0, b=B, wh=WH):
    """A seeded numpy batch in the JAX layout (NHWC proxy built as the
    drivers build it); the last row repeats the one before it and is
    masked out."""
    rs = np.random.RandomState(seed)
    _, j2d, proxy = seeded_proxies(rs, b, wh)
    aa = rs.randn(b * 24, 3).astype(np.float32) * 0.3
    pose = np.array(j_rodrigues(jnp.asarray(aa))).reshape(b, 24, 3, 3)
    betas = rs.randn(b, 10).astype(np.float32) * 0.5
    for x in (proxy, j2d, pose, betas):
        x[-1] = x[-2]
    mask = (np.arange(b) < b - 1).astype(np.float32)
    return {"proxy": proxy, "joints2d": j2d, "target_pose": pose,
            "target_betas": betas, "mask": mask}


def to_torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    if "proxy" in out:
        out["proxy"] = out["proxy"].permute(0, 3, 1, 2).contiguous()
    return out


def assert_params_agree(state, jstate, lr, what):
    """Every parameter within PARAM_TOL of JAX's except Adam's sign flips,
    which are counted; returns the count. A flip moves a scalar by at most
    2·lr in a step, and sits where the port's first moment is near zero:
    below FLIP_MU_SHARE of the tensor's mean magnitude."""
    got = tckpt.regressor_flat(state)[0]
    want = convert.flatten_tree(jax.device_get(jstate.params))
    mu = {k[len("mu/params/"):]: v for k, v in tckpt._opt_flat(state).items()
          if k.startswith("mu/params/")}
    assert set(got) == set(want)
    flips, total = 0, 0
    for k in want:
        gap = np.abs(got[k] - np.asarray(want[k]))
        far = gap > PARAM_TOL
        # One step apart at most, where the first moment is near zero.
        assert (gap[far] <= 2 * lr + PARAM_TOL).all(), (what, k,
                                                         gap[far][:5])
        assert (np.abs(mu[k][far]) <= FLIP_MU_SHARE * np.mean(
            np.abs(mu[k]))).all(), (what, k, np.abs(mu[k][far]).max())
        flips += int(far.sum())
        total += gap.size
    print("%s: %d Adam sign flips of %d scalars" % (what, flips, total))
    assert flips <= MAX_FLIP_SHARE * total, (what, flips)
    return flips


def assert_stats_agree(state, jstate, what):
    got = tckpt.regressor_flat(state)[1]
    want = convert.flatten_tree(jax.device_get(jstate.batch_stats))
    assert set(got) == set(want)
    worst = 0.0
    for k in want:
        w = np.asarray(want[k])
        rel = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-12)
        worst = max(worst, rel)
        assert rel <= STATS_REL, (what, k, rel)
    print("%s: BN statistics max relative gap %.3g" % (what, worst))


def assert_losses_agree(metrics, jmetrics, what):
    for k, v in jmetrics.items():
        w = float(v)
        g = float(metrics[k])
        assert abs(g - w) <= LOSS_REL * max(abs(w), 1e-12), (what, k, g, w)


@pytest.fixture(scope="module")
def both_assets():
    return jassets.synthesize_assets(), synthesize_assets()


def both_states(init=None):
    """JAX's regressor, fresh train state and optimizer (``init``: JAX's
    state-making function of (regressor, key), default the distillation
    one at LR)."""
    jreg = JRegressor(in_channels=18)
    if init is None:
        jstate, tx = jdistill.make_train_state(
            jreg, jax.random.PRNGKey(0), learning_rate=LR)
    else:
        jstate, tx = init(jreg, jax.random.PRNGKey(0))
    return jreg, jstate, tx


def port_state_like(jstate):
    """The port's distillation state carrying JAX's variables."""
    state = tdistill.make_train_state(SingleInputRegressor(in_channels=18),
                                      learning_rate=LR)
    return convert.train_state_from_jax(
        state, jax.device_get(jstate.params),
        jax.device_get(jstate.batch_stats), jax.device_get(jstate.log_vars))


def carry_jax_state(state, jstate):
    """Copy JAX's whole train state into the port's: variables and
    log-variances (``convert.train_state_from_jax``), Adam's moments and
    count (optax's ``ScaleByAdamState``), the step."""
    convert.train_state_from_jax(
        state, jax.device_get(jstate.params),
        jax.device_get(jstate.batch_stats), jax.device_get(jstate.log_vars))
    adam = jax.device_get(jstate.opt_state[0])
    layers = state.regressor.resnet_layers
    for which, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        params, log_vars = getattr(adam, which)
        flat = convert.flatten_tree(params)
        names = [convert.regressor_flax_name(n, layers)[len("params/"):]
                 for n, _ in state.regressor.named_parameters()]
        arrays = [flat[k] for k in names] + [log_vars[k]
                                             for k in state.log_vars]
        for key, m, a in zip(names + list(state.log_vars), moments, arrays):
            a = np.array(a, np.float32)
            if key.endswith("/kernel"):
                a = convert.from_flax_layout(a)
            m.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(
                m.shape))
    state.opt.count = int(adam.count)
    state.step = int(jstate.step)
    return state


def test_train_and_eval_steps_match_jax(both_assets):
    """Each train step from the same state (JAX's, carried across before
    the step), then the eval step."""
    ja, ta = both_assets
    jreg, jstate, tx = both_states()
    state = port_state_like(jstate)
    assert state.regressor.encoder.norm.running_var.sum() == 64
    jstep = jax.jit(jdistill.make_train_step(jreg, tx))
    jeval = jax.jit(jdistill.make_eval_step(jreg))
    step, evals = tdistill.make_train_step(), tdistill.make_eval_step()
    for i, seed in enumerate((0, 1)):
        carry_jax_state(state, jstate)
        nb = distill_batch(seed)
        jstate, jm, _ = jstep(jstate, ja, {k: jnp.asarray(v)
                                           for k, v in nb.items()})
        state, m, aux = step(state, ta, to_torch_batch(nb))
        assert state.step == i + 1 and state.opt.count == i + 1
        assert_losses_agree(m, jm, "train step %d" % (i + 1))
        for k, v in jstate.log_vars.items():
            assert abs(float(state.log_vars[k].detach()) - float(v)) \
                <= LOG_VAR_TOL
        assert_params_agree(state, jstate, LR, "train step %d" % (i + 1))
        assert_stats_agree(state, jstate, "train step %d" % (i + 1))
    # The eval step reads the running statistics and updates nothing.
    carry_jax_state(state, jstate)
    before = tckpt.regressor_flat(state)
    nb = distill_batch(2)
    jm, jaux = jeval(jstate, ja, {k: jnp.asarray(v) for k, v in nb.items()})
    m, aux = evals(state, ta, to_torch_batch(nb))
    assert_losses_agree(m, jm, "eval step")
    for half in (0, 1):
        after = tckpt.regressor_flat(state)[half]
        assert all(np.array_equal(after[k], before[half][k]) for k in after)
    gap = np.abs(aux["pred"]["verts"].numpy()
                 - np.asarray(jaux["pred"]["verts"])).max()
    assert gap <= 1e-4, gap
