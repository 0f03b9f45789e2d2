"""The port's process group and (data, model) grid on two gloo CPU ranks:
the mirror of ``tests/test_distributed.py`` (the slice, the topology, an
all-reduce sum) and of the JAX package's mesh helpers.

* ``initialize`` from its arguments (a ``file://`` rendezvous), from
  torchrun's environment and from the JAX package's, and the
  single-process no-op;
* the (2, 1) and (1, 2) grids, ``shard_batch``, ``replicate`` and the
  row all-gather;
* a global batch norm over the two ranks' halves of a batch (forward,
  input gradient, the summed weight and bias gradients, the running
  statistics with flax's biased variance) against one process on the
  whole batch, within 1e-6 of each quantity's scale (its largest
  magnitude, at least 1: the weight and bias gradients are sums over 90
  elements, ~20, where fp32 summation order alone moves 3e-6);
* ``convert.split_model_shards`` / ``gather_model_shards`` on JAX's unsplit
  distillation state carried across (``convert.train_state_from_jax``):
  each model rank's shard of a split layer is its slice of the flax
  kernel's output columns (and of Adam's moments, which split with it),
  the rest whole, and the shards gather back bit for bit.

One launch of two spawned ranks serves every test (``torch_parallel_
harness.py``).
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.models.regressor import (  # noqa: E402
    SingleInputRegressor as JRegressor)
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.models.resnet import BatchNorm2d  # noqa
from soccerplayershapepose_torch.parallel import (  # noqa: E402
    data_sharding, initialize, local_batch_slice, make_mesh, replicate,
    shard_batch)
from soccerplayershapepose_torch.parallel import collectives  # noqa: E402
from soccerplayershapepose_torch.train import distill  # noqa: E402

from torch_parallel_harness import run_ranks  # noqa: E402

BN_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def bn_inputs():
    rs = np.random.RandomState(0)
    x = (rs.randn(6, 4, 5, 3) * rs.uniform(0.5, 3.0, (1, 4, 1, 1))
         + rs.uniform(-2, 2, (1, 4, 1, 1))).astype(np.float32)
    return {"x": x, "dy": rs.randn(*x.shape).astype(np.float32),
            "w": rs.uniform(0.5, 1.5, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("basics", 2, tmp_path_factory.mktemp("basics"),
                     bn=bn_inputs(), ports=_free_ports(2))


def test_topology_slice_and_all_reduce(ranks):
    for pid, r in enumerate(ranks):
        assert r["args"] == {"process_id": pid, "num_processes": 2,
                             "local_devices": 1, "global_devices": 2}
        # 8-sample global batch → 4 per rank.
        assert r["slice"] == (pid * 4, 4)
        # sum over ranks of [1..4] and [5..8]
        np.testing.assert_array_equal(r["all_reduce"], [6, 8, 10, 12])


@pytest.mark.parametrize("kind", ["torchrun", "jax_env"])
def test_initialize_from_environment(ranks, kind):
    for pid, r in enumerate(ranks):
        got = r[kind]
        assert got["process_id"] == pid and got["num_processes"] == 2
        assert got["backend"] == "gloo"
        assert got["all_reduce"] == 3.0


def test_grids_shard_batch_and_replicate(ranks):
    for pid, r in enumerate(ranks):
        (dp_shape, dp_row, dp_col), (mp_shape, mp_row, mp_col) = r["grids"]
        assert dp_shape == {"data": 2, "model": 1} and (dp_row, dp_col) \
            == (pid, 0)
        assert mp_shape == {"data": 1, "model": 2} and (mp_row, mp_col) \
            == (0, pid)
        rows = slice(4 * pid, 4 * pid + 4)
        np.testing.assert_array_equal(
            r["shard"]["a"], np.arange(16.0).reshape(8, 2)[rows])
        np.testing.assert_array_equal(r["shard"]["b"][0], np.arange(8)[rows])
        assert r["shard"]["b"][1][0].shape == (4, 3)
        # On a (1, 2) grid every rank holds the whole batch.
        np.testing.assert_array_equal(r["shard_model_grid"]["a"],
                                      np.arange(16.0).reshape(8, 2))
        # Rank 0's tensors everywhere.
        np.testing.assert_array_equal(r["replicate"][0], [7.0, 7.0, 7.0])
        np.testing.assert_array_equal(r["replicate"][1], np.zeros((2, 2)))
        np.testing.assert_array_equal(r["gather_rows"],
                                      [[0, 0], [0, 0], [1, 1], [1, 1]])


def test_global_batch_norm_matches_one_process(ranks):
    d = bn_inputs()
    norm = BatchNorm2d(4, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(d["w"]))
        norm.bias.copy_(torch.from_numpy(d["b"]))
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    y = norm.train()(x)
    (y * torch.from_numpy(d["dy"])).sum().backward()
    want = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": norm.weight.grad.numpy(), "db": norm.bias.grad.numpy(),
            "mean": norm.running_mean.numpy(),
            "var": norm.running_var.numpy()}
    gaps = {}
    for pid, r in enumerate(ranks):
        rows = slice(3 * pid, 3 * pid + 3)
        for k, w in want.items():
            got = r["bn"][k]
            w = w[rows] if k in ("y", "dx") else w
            gap = np.abs(got - w).max() / max(1.0, np.abs(w).max())
            gaps[k] = max(gaps.get(k, 0.0), float(gap))
    print("global batch norm vs one process:", gaps)
    assert max(gaps.values()) <= BN_TOL, gaps
    # flax's running variance takes the biased batch variance
    var = d["x"].astype(np.float64).var(axis=(0, 2, 3))
    np.testing.assert_allclose(want["var"], 0.9 + 0.1 * var, rtol=1e-6)


def test_single_process_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert initialize(device="cpu") == {
        "process_id": 0, "num_processes": 1, "local_devices": 1,
        "global_devices": 1}
    assert not torch.distributed.is_initialized()
    assert local_batch_slice(8) == (0, 8)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.model_group is None
    x = torch.arange(6.0).reshape(3, 2)
    assert data_sharding(mesh, 3) == slice(0, 3)
    np.testing.assert_array_equal(shard_batch({"x": x}, mesh)["x"], x)
    assert replicate(x, mesh) is x
    np.testing.assert_array_equal(collectives.all_gather_rows(x, None), x)
    np.testing.assert_array_equal(collectives.all_reduce_sum(x, None), x)
    with pytest.raises(ValueError, match="model_parallel"):
        make_mesh(model_parallel=2)


def test_initialize_needs_a_rank_and_a_size(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="world size and a rank"):
        initialize("127.0.0.1:1", device="cpu")


def test_model_shards_of_jax_state_split_and_gather():
    jstate, _ = jdistill.make_train_state(
        JRegressor(in_channels=18), jax.random.PRNGKey(0), learning_rate=1e-3)
    state = convert.train_state_from_jax(
        distill.make_train_state(SingleInputRegressor(in_channels=18)),
        *(jax.device_get(x) for x in (jstate.params, jstate.batch_stats,
                                      jstate.log_vars)))
    full = state.regressor.state_dict()
    shapes = {k: v.shape for k, v in full.items()}
    shards = [convert.split_model_shards(full, 2, i) for i in range(2)]
    ief = jax.device_get(jstate.params)["IEFModule_0"]
    for i, shard in enumerate(shards):
        for layer, rows in ((0, 256), (1, 256)):
            got = shard["ief.fcs.%d.weight" % layer].numpy()
            kernel = np.asarray(ief["Dense_%d" % layer]["kernel"])
            assert got.shape == (rows, kernel.shape[0])
            np.testing.assert_array_equal(
                got, kernel[:, i * rows:(i + 1) * rows].T)
        assert shard["ief.fcs.0.bias"].shape == (512,)
        assert shard["ief.fcs.2.weight"].shape == (157, 512)   # 157 is odd
        assert shard["encoder.conv.weight"].shape == full[
            "encoder.conv.weight"].shape
    back = convert.gather_model_shards(shards, shapes)
    assert set(back) == set(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    # Adam's moments, keyed by their parameters, split with them.
    names = [n for n, _ in state.regressor.named_parameters()]
    mu = {n: torch.randn(p.shape) for n, p in
          state.regressor.named_parameters()}
    mu_shards = [convert.split_model_shards(mu, 2, i) for i in range(2)]
    assert mu_shards[1]["ief.fcs.1.weight"].shape == (256, 512)
    back = convert.gather_model_shards(mu_shards, {n: mu[n].shape
                                                   for n in names})
    assert all(torch.equal(back[n], mu[n]) for n in names)
