"""The perception weight files
(``train/perception.py:save_perception_weights`` /
``load_perception_weights``) and the carry of optax's Adam state
(``convert.perception_state_from_jax``) against the JAX package.

* the weights both ways between the packages (f32 and f16-packed): JAX's
  file loads into the port's net, the port's (after one port step, so the
  statistics moved) into JAX's, with the same keys and outputs within
  1e-4; the port's load is strict;
* Adam's moments and count carried bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models import detector as tdet  # noqa
from soccerplayershapepose_torch.models.perception import ProxyNet  # noqa
from soccerplayershapepose_torch.train import perception as ttrain  # noqa

from test_torch_perception_train import (  # noqa: E402
    CH, LR, JitNet, blob_images, jax_proxynet_state, port_state,
    proxynet_batch, torch_batch)

DET_HW = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_batch(seed=0, b=2, hw=DET_HW, n=4):
    rs = np.random.RandomState(seed)
    image, _ = blob_images(rs, b, *hw)
    h, w = hw
    x1 = rs.uniform(-10, w - 20, (b, n))
    y1 = rs.uniform(-10, h - 30, (b, n))
    boxes = np.stack([x1, y1, x1 + rs.uniform(8, 30, (b, n)),
                      y1 + rs.uniform(16, 50, (b, n))], -1)
    boxes[0, 0] = [-50, -50, -10, -10]          # centre off the frame
    return {"image": image, "boxes": boxes.astype(np.float32),
            "mask": (rs.rand(b, n) > 0.2).astype(np.float32),
            "visible_fill": rs.uniform(0.02, 0.45, (b, n)).astype(
                np.float32)}




def jax_detector_state(seed=0):
    model = jdet.PlayerDetector(channels=CH)
    state, tx = jtrain.make_detector_state(model, jax.random.PRNGKey(seed),
                                           hw=DET_HW, learning_rate=LR)
    return model, state, tx


# ---------------------------------------------------------------------------
# Weights both ways
# ---------------------------------------------------------------------------

# One compiled eval-mode forward per net, shared by the file's cases.
_EVAL_NETS = {}


@pytest.mark.parametrize("kind", ["proxynet", "detector"])
@pytest.mark.parametrize("dtype", [None, np.float16])
def test_perception_weights_round_trip_between_packages(tmp_path, kind,
                                                        dtype):
    rs = np.random.RandomState(5)
    if kind == "proxynet":
        jmodel, jstate, _ = jax_proxynet_state(seed=3, wh=64)
        tmodel, hw = ProxyNet(channels=CH), (64, 64)
    else:
        jmodel, jstate, _ = jax_detector_state(seed=3)
        tmodel, hw = tdet.PlayerDetector(channels=CH), DET_HW
    image, _ = blob_images(rs, 1, *hw)
    # JAX → port: JAX's saved file loads into the port's net.
    jpath = str(tmp_path / "jax.npz")
    jtrain.save_perception_weights(jpath, jstate, dtype=dtype,
                                   compress=dtype is not None)
    ttrain.load_perception_weights(jpath, tmodel)
    # port → JAX: the port's file (after one port step, so the statistics
    # moved) loads in JAX and the outputs agree.
    state = ttrain.make_perception_state(tmodel, LR)
    if kind == "proxynet":
        ttrain.make_proxynet_train_step()(state, torch_batch(
            proxynet_batch(6, b=2, wh=64)))
    else:
        ttrain.make_detector_train_step()(state, torch_batch(frame_batch(6)))
    tpath = str(tmp_path / "port.npz")
    ttrain.save_perception_weights(tpath, tmodel, dtype=dtype,
                                   compress=dtype is not None)
    z = np.load(tpath)
    assert set(z.files) == set(np.load(jpath).files)
    assert all(z[k].dtype == (dtype or np.float32) for k in z.files)
    variables = jtrain.load_perception_weights(tpath, jmodel, hw=hw)
    back = ttrain.load_perception_weights(
        tpath, type(tmodel)(channels=CH)).eval()
    if kind not in _EVAL_NETS:
        _EVAL_NETS[kind] = JitNet(jmodel)
    want = _EVAL_NETS[kind].apply(variables, jnp.asarray(image))
    with torch.no_grad():
        got = back(torch.from_numpy(image).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)
    # The port's load is strict.
    flat = dict(np.load(tpath))
    flat.pop(next(k for k in flat if k.startswith("batch_stats/")))
    np.savez(str(tmp_path / "short.npz"), **flat)
    with pytest.raises(ValueError):
        ttrain.load_perception_weights(str(tmp_path / "short.npz"),
                                       type(tmodel)(channels=CH))


def test_adam_state_carried_from_jax():
    """``perception_state_from_jax`` carries optax's moments and count
    (here seeded normal moments in optax's own state) bit for bit."""
    _, jstate, _ = jax_proxynet_state(seed=4, wh=64)
    rs = np.random.RandomState(8)
    moments = [jax.tree_util.tree_map(
        lambda p: rs.randn(*p.shape).astype(np.float32), jstate.params)
        for _ in range(2)]
    adam = optax.ScaleByAdamState(count=jnp.asarray(3, jnp.int32),
                                  mu=moments[0], nu=moments[1])
    jstate = jstate._replace(opt_state=(adam,) + tuple(
        jstate.opt_state[1:]))
    state = port_state(ProxyNet(channels=CH), jstate)
    assert state.opt.count == 3
    for tree, port in ((adam.mu, state.opt.mu), (adam.nu, state.opt.nu)):
        flat = convert.flatten_tree(tree)
        for (name, _), m in zip(state.model.named_parameters(), port):
            key = convert.perception_flax_name(name)[len("params/"):]
            a = np.asarray(flat[key])
            if key.endswith("/kernel"):
                a = convert.from_flax_layout(a)
            np.testing.assert_array_equal(m.numpy(), a)
