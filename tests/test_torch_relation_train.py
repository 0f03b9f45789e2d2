"""The port's relation trainer against the JAX package's.

* :func:`warmup_cosine_decay` against ``optax.warmup_cosine_decay_schedule``
  at every step of a 50-step run (and past its end): ≤ 1e-6 relative
  (optax computes in fp32);
* 3 train steps of v0 (``WV`` zeroed, as ``train_relation`` starts it) and
  of v1 from JAX's initial parameters carried across, on JAX's batches,
  with the warmup-cosine rate of a 30-step run: the loss and
  ``input_mse`` ≤ 1e-5 relative, the parameters ≤ 1e-6 absolute after
  each step except Adam's sign flips (counted, ≤ 1%). The first update
  has rate 0 on both sides, so the first step leaves the weights as they
  were;
* ``save_relation_weights`` → JAX's ``load_relation_weights`` and the
  port's: the same module, bit for bit; ``train_relation`` runs and
  lowers the loss below the input's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from soccerplayershapepose_tpu.models import relation as jrel  # noqa: E402
from soccerplayershapepose_tpu.train import relation as jtrain  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.relation import (  # noqa: E402
    PoseRelationModule)
from soccerplayershapepose_torch.train import relation as ttrain  # noqa: E402

B, N, STEPS, LR = 2, 4, 30, 1e-3
SCHED_REL = 1e-6
LOSS_REL = 1e-5
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, LR, 5, 50, LR * 0.05)
    got = ttrain.warmup_cosine_decay(0.0, LR, 5, 50, LR * 0.05)
    for count in range(60):
        w = float(want(count))
        assert abs(got(count) - w) <= SCHED_REL * LR, (count, got(count), w)
    assert got(0) == 0.0 and got(49) > got(50) == pytest.approx(LR * 0.05)


def _jax_init(version):
    kwargs = jtrain.V1_KWARGS if version else {}
    relation = jrel.PoseRelationModule(**kwargs)
    dummy = jtrain.synth_relation_batch(jax.random.PRNGKey(1), b=1,
                                        n_players=N)
    params = relation.init(jax.random.PRNGKey(0), dummy["rotmats_noisy"],
                           dummy["boxes"], dummy["mask"])
    if not version:
        params = jax.tree_util.tree_map(lambda x: x, params)
        params["params"]["WV"] = {k: jnp.zeros_like(v) for k, v in
                                  params["params"]["WV"].items()}
    return relation, params


def _port_module(params, version):
    model = PoseRelationModule(**(ttrain.V1_KWARGS if version else {}))
    sd = convert.relation_state_dict_from_flat(
        convert.flatten_tree(jax.device_get(params)))
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("version", [0, 1])
def test_train_steps_match_jax(version):
    relation, params = _jax_init(version)
    tx = optax.adam(optax.warmup_cosine_decay_schedule(
        0.0, LR, max(STEPS // 10, 1), STEPS, LR * 0.05))
    jstate = jtrain.RelationTrainState(params, tx.init(params),
                                       jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_relation_train_step(relation, tx))
    state = ttrain.make_relation_state(_port_module(params, version), STEPS,
                                       LR)
    step = ttrain.make_relation_train_step()
    first = {k: v.clone() for k, v in state.relation.state_dict().items()}
    flips = 0
    for i in range(3):
        batch = jtrain.synth_relation_batch(jax.random.PRNGKey(10 + i), b=B,
                                            n_players=N)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        for k in ("loss", "input_mse"):
            w = float(jm[k])
            assert abs(float(m[k]) - w) <= LOSS_REL * abs(w), (i, k)
        if i == 0:
            assert all(torch.equal(v, first[k]) for k, v in
                       state.relation.state_dict().items())
        got = convert.relation_flat_from_module(state.relation)
        want = convert.flatten_tree({"params": jax.device_get(
            jstate.params["params"])})
        assert set(got) == set(want)
        for k in want:
            gap = np.abs(got[k] - want[k])
            far = gap > PARAM_TOL
            assert (gap[far] <= 2 * LR + PARAM_TOL).all(), (i, k)
            flips += int(far.sum())
    total = sum(p.numel() for p in state.relation.parameters())
    print("relation v%d: %d Adam sign flips of %d scalars over 3 steps"
          % (version, flips, total))
    assert flips <= 0.01 * total
    assert state.step == 3 and state.opt.count == 3


@pytest.mark.parametrize("version", [0, 1])
def test_save_load_round_trip(tmp_path, version):
    model = ttrain.new_relation(1024 if version else None,
                                torch.Generator().manual_seed(3), "cpu")
    if not version:
        assert not model.WV.weight.any() and not model.WV.bias.any()
    path = str(tmp_path / "rel.npz")
    ttrain.save_relation_weights(path, model)
    back = ttrain.load_relation_weights(path, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # JAX reads the same file into the same numbers.
    relation = jrel.PoseRelationModule(**(jtrain.V1_KWARGS if version
                                          else {}))
    jparams = jtrain.load_relation_weights(path, relation, n_players=N)
    flat = convert.flatten_tree(jax.device_get(jparams))
    mine = convert.relation_flat_from_module(model)
    assert set(flat) == set(mine)
    assert all(np.array_equal(flat[k], mine[k]) for k in mine)


def test_train_relation_learns():
    relation, history = ttrain.train_relation(
        steps=40, b=B, n_players=N, log_every=20, verbose=False,
        device="cpu")
    assert [h["step"] for h in history] == [20, 40]
    assert history[-1]["loss"] < history[-1]["input_mse"]
    assert not relation.training
