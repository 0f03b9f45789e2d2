"""The port's checkpoints: the JAX package's layout both ways, and resume.

* save → restore into a fresh trainer state: the regressor's state dict,
  the log-variances, Adam's moments and count, the step and ``meta.json``
  (its keys the JAX package's) come back exactly; ``params.npz`` holds
  the JAX package's flat names;
* resume: 1 epoch, then ``resume`` to a 2nd, equals 2 epochs without a
  break, bit for bit on the CPU (weights, BN statistics, log-variances,
  best weights, history);
* a checkpoint the JAX package wrote restores into the port, which then
  predicts what JAX predicts from it (≤ 1e-4 max abs on cam, pose and
  shape at a 64² proxy, fp32 convolutions in another order); one the port
  wrote restores into JAX, bit for bit.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.ief import (  # noqa: E402
    default_initial_params as j_init_params)
from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import checkpoint as jckpt  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.drivers import training as ttraining  # noqa: E402,E501
from soccerplayershapepose_torch.models.ief import (  # noqa: E402
    default_initial_params)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import checkpoint as tckpt  # noqa: E402
from soccerplayershapepose_torch.train import distill as tdistill  # noqa: E402

from test_training_driver import _dataset  # noqa: E402

PREDICT_TOL = 1e-4
META_KEYS = {"epoch", "best_epoch", "best_epoch_val_metrics",
             "save_val_metrics", "step"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trained_state(seed=0):
    """A port state after one step on random data (moments non-zero)."""
    state = tdistill.make_train_state(tdistill.new_regressor(18, seed, "cpu"),
                                      learning_rate=1e-3)
    rs = np.random.RandomState(seed)
    pose = torch.eye(3).expand(3, 24, 3, 3).contiguous()
    batch = {"proxy": torch.from_numpy(rs.rand(3, 18, 32, 32)
                                       .astype(np.float32)),
             "joints2d": torch.from_numpy(rs.uniform(100, 400, (3, 17, 2))
                                          .astype(np.float32)),
             "target_pose": pose, "target_betas": torch.zeros(3, 10),
             "mask": torch.tensor([1.0, 1.0, 0.0])}
    tdistill.make_train_step()(state, synthesize_assets(), batch)
    return state


def test_save_restore_round_trip(tmp_path):
    state = _trained_state()
    best = tckpt.params_snapshot(state)
    mgr = tckpt.CheckpointManager(str(tmp_path), ["pves_pa", "mpjpes_pa"])
    path = mgr.save(3, state, best, 2, {"pves_pa": 0.1, "mpjpes_pa": 0.2})
    assert sorted(os.listdir(path)) == [
        "batch_stats.npz", "best_params.npz", "log_vars.npz", "meta.json",
        "opt_state.npz", "params.npz"]
    assert not os.path.exists(path + ".tmp")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS and meta["step"] == 1
    with np.load(os.path.join(path, "params.npz")) as z:
        assert "ResNet_0/Conv_0/kernel" in z.files
        assert z["ResNet_0/Conv_0/kernel"].shape == (7, 7, 18, 64)
    fresh = tdistill.make_train_state(tdistill.new_regressor(18, 5, "cpu"),
                                      learning_rate=1e-3)
    fresh, best_back, meta_back = mgr.restore(fresh)
    assert meta_back == meta and fresh.step == 1 and fresh.opt.count == 1
    for k, v in state.regressor.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.regressor.state_dict()[k], v), k
    for k in state.log_vars:
        assert torch.equal(fresh.log_vars[k], state.log_vars[k])
    for a, b in zip(fresh.opt.mu + fresh.opt.nu, state.opt.mu + state.opt.nu):
        assert torch.equal(a, b)
    assert all(np.array_equal(best_back[k], best[k]) for k in best)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    assets = synthesize_assets()
    roots = _dataset(tmp_path)
    kw = dict(max_players=3, seed=3, learning_rate=1e-3, device="cpu")
    full = ttraining.train_regressor(
        assets, *roots, str(tmp_path / "full"), epochs=2,
        log_path=str(tmp_path / "full.pkl"), **kw)
    ttraining.train_regressor(assets, *roots, str(tmp_path / "cut"),
                              epochs=1, log_path=str(tmp_path / "cut.pkl"),
                              **kw)
    resumed = ttraining.train_regressor(
        assets, *roots, str(tmp_path / "cut"), epochs=2, resume=True,
        log_path=str(tmp_path / "cut.pkl"), **kw)
    assert len(resumed["history"]["train_losses"]) == 2
    assert resumed["history"] == full["history"]
    assert resumed["best_epoch"] == full["best_epoch"]
    assert resumed["state"].step == full["state"].step == 2
    for k, v in full["state"].regressor.state_dict().items():
        assert torch.equal(resumed["state"].regressor.state_dict()[k], v), k
    for k, v in full["state"].log_vars.items():
        assert torch.equal(resumed["state"].log_vars[k], v)
    assert all(np.array_equal(resumed["best_params"][k], v)
               for k, v in full["best_params"].items())


def test_checkpoints_cross_between_packages(tmp_path):
    ja = jassets.synthesize_assets()
    jreg = JRegressor(in_channels=18)
    jstate, _ = jdistill.make_train_state(jreg, jax.random.PRNGKey(4))
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), ["pves_pa"])
    jmgr.save(1, jstate, jstate.params, 1, {"pves_pa": 0.5})
    state = tdistill.make_train_state(tdistill.new_regressor(18, 0, "cpu"))
    state, best, meta = tckpt.CheckpointManager(
        str(tmp_path / "jax")).restore(state)
    assert meta["epoch"] == 1 and set(meta) == META_KEYS
    # JAX's prediction and the port's from the restored weights.
    proxy = np.random.RandomState(0).rand(2, 64, 64, 18).astype(np.float32)
    want = jreg.apply({"params": jstate.params,
                       "batch_stats": jstate.batch_stats}, jnp.asarray(proxy),
                      j_init_params(ja.mean_pose_rot6d, ja.mean_shape))
    ta = synthesize_assets()
    with torch.no_grad():
        got = state.regressor.eval()(
            torch.from_numpy(proxy).permute(0, 3, 1, 2).contiguous(),
            default_initial_params(ta.mean_pose_rot6d, ta.mean_shape))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= PREDICT_TOL
    # The port's checkpoint into JAX.
    path = tckpt.CheckpointManager(str(tmp_path / "port")).save(
        1, state, best, 1, {})
    back = jckpt._unflatten_like(jstate.params, dict(np.load(
        os.path.join(path, "params.npz"))))
    for k, v in convert.flatten_tree(jax.device_get(back)).items():
        assert np.array_equal(v, convert.flatten_tree(
            jax.device_get(jstate.params))[k]), k
