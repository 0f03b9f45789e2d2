"""The port's perception training (``train/perception.py``) against the
JAX package's, on seeded numpy batches and JAX's own variables carried
across (``convert.perception_state_from_jax``).

* ``proxynet_losses`` at 128², B = 2, each term within 1e-5 relative in
  train and eval mode, with every crop IUV-labelled and with one crop's
  ``iuv_valid`` 0, and without the IUV head. The keypoint positives
  (target ≥ 0.999) are a discrete decision on fp32 near-ties: the cells
  where the two packages decide differently are counted and printed, and
  must be none for the losses to be held;
* one ProxyNet step from JAX's fresh state (Adam's moments and count
  carried too): the losses within 1e-5 relative, BN
  statistics within 1e-5 relative, every parameter within 1e-6 except
  Adam's sign flips, which move a scalar by at most 2·lr, are counted, and
  stay under 1% of the scalars.

JAX's losses and steps run eagerly: under ``jax.jit`` XLA rewrites
``log(1 − p + eps)`` (``tests/test_torch_selfsup.py``). Only the nets'
forward (and so its backward) and Adam's update are compiled, each a
``jax.jit`` of its own (:class:`JitNet`), which the losses' logarithms are
not part of; eager convolutions would take minutes to dispatch.

The nets are narrow (head width 32) and the crops small; the batches are
smooth blobs with elliptic silhouettes, not uniform noise, whose last
trunk stage would have almost no batch variance. The detector's targets,
loss and step and the weight files are held in
``tests/test_torch_perception_weights.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from soccerplayershapepose_tpu.models import perception as jperc  # noqa
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.perception import ProxyNet  # noqa
from soccerplayershapepose_torch.train import perception as ttrain  # noqa

B, WH, CH, LR = 2, 128, 32, 1e-3
LOSS_REL = 1e-5
STATS_REL = 1e-5
PARAM_TOL = 1e-6
MAX_FLIP_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blob_images(rs, b, h, w):
    """Smooth colour fields with a bright ellipse: (B, h, w, 3) in [0, 1]
    and the ellipses' masks (B, h, w)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    low = rs.rand(b, 4, 4, 3).astype(np.float32)
    up = np.kron(low, np.ones((1, h // 4, w // 4, 1), np.float32))
    c = rs.uniform([0.35 * w, 0.3 * h], [0.65 * w, 0.7 * h], (b, 2))
    r = rs.uniform([0.12 * w, 0.2 * h], [0.2 * w, 0.3 * h], (b, 2))
    sil = ((((xx - c[:, :1, None]) / r[:, :1, None]) ** 2
            + ((yy - c[:, 1:, None]) / r[:, 1:, None]) ** 2) < 1
           ).astype(np.float32)
    img = 0.6 * up + 0.4 * sil[..., None] * rs.rand(b, 1, 1, 3)
    img = img + 0.03 * rs.randn(b, h, w, 3)
    return np.clip(img, 0, 1).astype(np.float32), sil


def proxynet_batch(seed=0, b=B, wh=WH, iuv_valid=None):
    rs = np.random.RandomState(seed)
    image, sil = blob_images(rs, b, wh, wh)
    s = wh // 4
    part = rs.randint(0, 25, (b, s, s)).astype(np.int32)
    part[:, : s // 4] = 0
    batch = {"image": image, "silhouette": sil,
             "joints2d": rs.uniform(4, wh - 4, (b, 17, 2)).astype(
                 np.float32),
             "kp_visible": (rs.rand(b, 17) > 0.2).astype(np.float32),
             "part": part,
             "uv": rs.rand(b, s, s, 2).astype(np.float32)}
    if iuv_valid is not None:
        batch["iuv_valid"] = np.asarray(iuv_valid, np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class JitNet:
    """A flax net whose ``apply`` is compiled (train mode with the batch
    statistics mutable, and eval mode), for JAX's loss functions, which
    call ``model.apply`` and read ``model.with_iuv``."""

    def __init__(self, model):
        self.with_iuv = getattr(model, "with_iuv", False)
        self._train = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))
        self._eval = jax.jit(lambda v, x: model.apply(v, x, train=False))

    def apply(self, variables, images, train=False, mutable=None):
        return (self._train if train else self._eval)(variables, images)


def jit_update(tx):
    return optax.GradientTransformation(tx.init, jax.jit(tx.update))


def jax_proxynet_state(with_iuv=True, seed=0, wh=WH):
    model = jperc.ProxyNet(with_iuv=with_iuv, channels=CH)
    state, tx = jtrain.make_proxynet_state(model, jax.random.PRNGKey(seed),
                                           wh=wh, learning_rate=LR)
    return model, state, tx


def port_state(model, jstate, opt=True):
    state = ttrain.make_perception_state(model, LR)
    return convert.perception_state_from_jax(
        state, jax.device_get(jstate.params),
        jax.device_get(jstate.batch_stats),
        jax.device_get(jstate.opt_state) if opt else None)


def rel(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    return abs(got - float(want)) / max(abs(float(want)), 1e-12)


# ---------------------------------------------------------------------------
# ProxyNet's losses
# ---------------------------------------------------------------------------

def positive_flips(batch, wh=WH):
    """Cells whose keypoint positive (target ≥ 0.999) the two packages
    decide differently."""
    small = wh // 4
    j = batch["joints2d"] * (small / wh)
    jt = jtrain.gaussian_heatmap_targets(jnp.asarray(j), small)
    jt = np.asarray(jt / jnp.maximum(jnp.max(jt, axis=(1, 2),
                                             keepdims=True), 1e-6))
    tt = ttrain.gaussian_heatmap_targets(torch.from_numpy(j), small)
    tt = (tt / torch.clamp(torch.amax(tt, dim=(1, 2), keepdim=True),
                           min=1e-6)).numpy()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    return int(((tt >= 0.999) != (jt >= 0.999)).sum())


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("iuv_valid", [None, [1.0, 0.0]])
def test_proxynet_losses_match_jax(train, iuv_valid):
    model, jstate, _ = jax_proxynet_state()
    batch = proxynet_batch(0, iuv_valid=iuv_valid)
    flips = positive_flips(batch)
    print("keypoint positives decided differently: %d cells" % flips)
    assert flips == 0
    _, (jl, jstats) = jtrain.proxynet_losses(
        JitNet(model), jstate.params, jstate.batch_stats, jax_batch(batch),
        train=train)
    state = port_state(ProxyNet(channels=CH), jstate, opt=False)
    with torch.set_grad_enabled(train):
        _, tl = ttrain.proxynet_losses(state.model, torch_batch(batch),
                                       train=train)
    assert set(tl) == set(jl) == {"kp", "mask", "part", "uv", "total"}
    gaps = {k: rel(tl[k], jl[k]) for k in jl}
    print("proxynet_losses relative gaps:", gaps)
    assert max(gaps.values()) <= LOSS_REL, gaps


def test_proxynet_losses_without_iuv_head():
    model, jstate, _ = jax_proxynet_state(with_iuv=False)
    batch = proxynet_batch(1)
    del batch["kp_visible"]
    _, (jl, _) = jtrain.proxynet_losses(JitNet(model), jstate.params,
                                        jstate.batch_stats, jax_batch(batch))
    state = port_state(ProxyNet(with_iuv=False, channels=CH), jstate,
                       opt=False)
    _, tl = ttrain.proxynet_losses(state.model, torch_batch(batch))
    assert set(tl) == set(jl) == {"kp", "mask", "total"}
    assert max(rel(tl[k], jl[k]) for k in jl) <= LOSS_REL


# ---------------------------------------------------------------------------
# One train step from JAX's state
# ---------------------------------------------------------------------------

def assert_state_agrees(state, jstate, lr, what):
    """BN statistics within STATS_REL; every parameter within PARAM_TOL
    except Adam's sign flips (each at most 2·lr, all under
    MAX_FLIP_SHARE of the scalars). Returns the flips."""
    flat = convert.proxynet_flat_from_state_dict(state.model.state_dict())
    want = convert.flatten_tree({"params": jax.device_get(jstate.params),
                                 "batch_stats": jax.device_get(
                                     jstate.batch_stats)})
    assert set(flat) == set(want)
    flips = total = 0
    worst_stat = 0.0
    for k, w in want.items():
        w = np.asarray(w)
        gap = np.abs(flat[k] - w)
        if k.startswith("batch_stats/"):
            r = gap.max() / max(np.abs(w).max(), 1e-12)
            worst_stat = max(worst_stat, r)
            assert r <= STATS_REL, (what, k, r)
            continue
        far = gap > PARAM_TOL
        assert (gap[far] <= 2 * lr + PARAM_TOL).all(), (what, k,
                                                         gap[far][:5])
        flips += int(far.sum())
        total += gap.size
    print("%s: %d Adam sign flips of %d scalars; BN statistics %.3g"
          % (what, flips, total, worst_stat))
    assert flips <= MAX_FLIP_SHARE * total, (what, flips)
    return flips


def test_proxynet_train_step_matches_jax():
    model, jstate, tx = jax_proxynet_state()
    state = port_state(ProxyNet(channels=CH), jstate)
    batch = proxynet_batch(2, iuv_valid=[1.0, 0.0])
    assert positive_flips(batch) == 0
    jstate, jl = jtrain.make_proxynet_train_step(
        JitNet(model), jit_update(tx))(jstate, jax_batch(batch))
    state, tl = ttrain.make_proxynet_train_step()(state, torch_batch(batch))
    assert state.step == 1 and state.opt.count == 1
    gaps = {k: rel(tl[k], jl[k]) for k in jl}
    assert max(gaps.values()) <= LOSS_REL, gaps
    assert_state_agrees(state, jstate, LR, "proxynet step")
