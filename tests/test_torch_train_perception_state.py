"""The training driver's state file (``scripts/train_perception_torch.py``:
:func:`state_flat`, :func:`load_state`, :func:`save_state`,
:func:`save_weights`, :func:`finetune_from`) against the JAX script's
``_save_state`` and ``_load_state``, on the CPU.

For each kind (ProxyNet and the detector at head width 8, the ResNet-18
regressor), JAX's state with seeded Adam moments, log-variances and a step
count of 7:

* the port's key set is JAX's ``_flatten`` of the state: 144
  ``opt_state`` keys for the regressor, its moments split into ``/0/``
  (the parameters) and ``/1/`` (the log-variances), and neither the split
  nor ``log_vars/`` in the perception states;
* JAX's ``_save_state`` → the port's :func:`load_state` →
  :func:`save_state` gives JAX's arrays back bit for bit, dtype and shape
  included, and JAX's ``_load_state`` reads the port's file into JAX's
  state;
* ``weights_last.npz`` holds JAX's ``params/`` and ``batch_stats/``
  arrays, and :func:`finetune_from` loads them into a fresh state with
  Adam untouched;
* a regressor npz with a ``log_vars/`` collection loads (the collection
  left out); any other stray variable is refused.

JAX's nets are not run: their ``init`` gives seeded variables of the
shapes ``jax.eval_shape`` traces (an eager flax initialisation takes half
a minute a net on one core).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.detector import (  # noqa: E402
    PlayerDetector as JDetector)
from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.train import distill  # noqa: E402
from soccerplayershapepose_torch.train import straps  # noqa: E402

from test_torch_train_perception import SMALL, cpu_args  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_perception as jscript  # noqa: E402
import train_perception_torch as tp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def seeded_init():
    """The flax nets' ``init`` gives seeded normal variables of the shapes
    ``jax.eval_shape`` traces: the states' layout, without compiling or
    running a net."""
    mp = pytest.MonkeyPatch()
    rs = np.random.RandomState(0)
    for cls in (JProxyNet, JDetector, JRegressor):
        plain = cls.init

        def init(self, rng, *args, _plain=plain, **kw):
            shapes = jax.eval_shape(lambda r, *a: _plain(self, r, *a, **kw),
                                    rng, *args)
            return jax.tree_util.tree_map(lambda x: jnp.asarray(
                rs.randn(*x.shape).astype(x.dtype)), shapes)
        mp.setattr(cls, "init", init)
    yield
    mp.undo()


def _jax_setup(kind, args):
    return {"proxynet": jscript._proxynet_setup,
            "detector": jscript._detector_setup,
            "regressor": jscript._regressor_setup}[kind](args)


def _busy_jax_state(jstate, count):
    """JAX's state with seeded Adam moments, log-variances and a step
    count, so that the round trip carries more than zeros."""
    rs = np.random.RandomState(count)

    def fill(x):
        return jnp.asarray(np.asarray(rs.randn(*np.shape(x)),
                                      np.asarray(x).dtype))

    adam, sched = jstate.opt_state
    adam = adam._replace(count=jnp.asarray(count, jnp.int32),
                         mu=jax.tree_util.tree_map(fill, adam.mu),
                         nu=jax.tree_util.tree_map(
                             lambda x: jnp.abs(fill(x)), adam.nu))
    sched = sched._replace(count=jnp.asarray(count, jnp.int32))
    jstate = jstate._replace(opt_state=(adam, sched),
                             step=jnp.asarray(count, jnp.int32))
    if hasattr(jstate, "log_vars"):
        jstate = jstate._replace(log_vars=jax.tree_util.tree_map(
            fill, jstate.log_vars))
    return jstate


def _jax_flat(jstate):
    from soccerplayershapepose_tpu.train.checkpoint import _flatten
    tree = {"params": jstate.params, "batch_stats": jstate.batch_stats,
            "opt_state": jstate.opt_state, "step": jstate.step}
    if hasattr(jstate, "log_vars"):
        tree["log_vars"] = jstate.log_vars
    return _flatten(tree)


@pytest.mark.parametrize("kind", tp.KINDS)
def test_state_file_carries_both_ways(kind, tmp_path):
    args = cpu_args([kind, "--steps", "40"] + SMALL, tmp_path)
    _, _, jstate = _jax_setup(kind, args)
    jstate = _busy_jax_state(jstate, 7)
    want = _jax_flat(jstate)
    src, dst = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jscript._save_state(src, jstate)

    state = tp.load_state(src, tp.new_state(args, kind, "cpu"))
    assert state.step == 7 and state.opt.count == 7
    mine = tp.state_flat(state)
    assert set(mine) == set(want)
    opt_keys = [k for k in mine if k.startswith("opt_state/")]
    split = [k for k in opt_keys if k.startswith("opt_state/0/.mu/1/")]
    print("%s: %d keys, %d opt_state keys" % (kind, len(mine),
                                               len(opt_keys)))
    if kind == "regressor":
        assert len(opt_keys) == 144 and len(split) == 5
    else:
        assert not split and not any(k.startswith("log_vars/")
                                     for k in mine)
    tp.save_state(dst, state)
    with np.load(dst) as z:
        for k in z.files:
            assert z[k].dtype == want[k].dtype and z[k].shape == \
                want[k].shape, k
            assert np.array_equal(z[k], want[k]), k
    back = _jax_flat(jscript._load_state(dst, jstate))
    assert all(np.array_equal(back[k], want[k]) for k in want)

    # weights_last.npz: JAX's nets read the port's, the port's JAX's.
    wpath = str(tmp_path / "weights_last.npz")
    tp.save_weights(wpath, state)
    with np.load(wpath) as z:
        assert set(z.files) == {k for k in want if k.startswith(
            ("params/", "batch_stats/"))}
        assert all(np.array_equal(z[k], want[k]) for k in z.files)
    fresh = tp.new_state(args, kind, "cpu")
    tp.finetune_from(fresh, str(tmp_path))
    assert fresh.step == 0 and fresh.opt.count == 0
    assert all(np.array_equal(v, want[k]) for k, v in
               tp._variables_flat(fresh).items())


def test_regressor_load_ignores_only_log_vars(tmp_path):
    reg = distill.new_regressor(device="cpu", seed=3)
    path = str(tmp_path / "w.npz")
    straps.save_regressor_weights(path, reg)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    np.savez(path, **flat, **{"log_vars/verts": np.float32(0.5)})
    got = convert.load_regressor_weights(path, "cpu")
    assert all(torch.equal(v, got.state_dict()[k])
               for k, v in reg.state_dict().items())
    assert tp.load_regressor(path, 18, 18, "cpu") is not None
    np.savez(path, **flat, **{"extra/verts": np.float32(0.5)})
    with pytest.raises((ValueError, KeyError)):
        convert.load_regressor_weights(path, "cpu")
