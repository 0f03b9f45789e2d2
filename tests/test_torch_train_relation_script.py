"""``scripts/train_relation_torch.py`` against the JAX package's relation
trainer, on the CPU.

* ``train`` at 3 steps (B = 2 scenes of 4 players, lr 1e-3) from JAX's
  initial weights, on JAX's batches (``train_relation``'s own: the key
  split into init and data, batch ``i`` from ``fold_in(k_data, i + 1)``,
  the v0 value projection zeroed), given to the script's :func:`cmd_train`,
  against JAX's ``train_relation(PRNGKey(seed), steps=3, ...)``: the
  final parameters within 1e-6 except Adam's sign flips (each within
  2·lr, under 1% of the scalars), and each step's loss and ``input_mse``
  within 1e-5 relative of JAX's on the weights that step started from,
  which are JAX's run's own for the first two steps (the first update has
  rate 0; held to JAX's run there too). The third step follows an update
  at the peak rate whose counted sign flips move v1's loss 1.8e-5 from
  JAX's run (printed). The bars are those of
  ``tests/test_torch_relation_train.py``;
* the script writes ``relation_{v0,v1}.npz`` and its evaluation record
  into ``--out-dir`` only, and JAX's ``load_relation_weights`` reads the
  weights into the port's numbers;
* ``--out-dir`` is required and ``relate`` needs ``--root``
  (``relate`` itself: ``tests/test_torch_train_relation_relate.py``).
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.models import relation as jrel  # noqa: E402
from soccerplayershapepose_tpu.train import relation as jtrain  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.relation import (  # noqa: E402
    PoseRelationModule)
from soccerplayershapepose_torch.train import relation as ttrain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_relation_torch as tr  # noqa: E402

B, N, STEPS, LR, SEED = 2, 4, 3, 1e-3, 0
LOSS_REL = 1e-5
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nest(flat):
    """Flat ``params/...`` names → the nested variables ``apply`` takes."""
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.numpy.asarray(arr)
    return out


def jax_start(version):
    """JAX's ``train_relation`` initial parameters and batches."""
    relation = jrel.PoseRelationModule(**(jtrain.V1_KWARGS if version
                                          else {}))
    k_init, k_data = jax.random.split(jax.random.PRNGKey(SEED))
    dummy = jtrain.synth_relation_batch(jax.random.fold_in(k_data, 0), b=1,
                                        n_players=N)
    params = relation.init(k_init, dummy["rotmats_noisy"], dummy["boxes"],
                           dummy["mask"])
    flat = convert.flatten_tree(jax.device_get(params))
    if not version:
        flat = {k: np.zeros_like(v) if k.startswith("params/WV/") else v
                for k, v in flat.items()}
    batch_fn = jax.jit(lambda k: jtrain.synth_relation_batch(
        k, b=B, n_players=N))
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in batch_fn(
        jax.random.fold_in(k_data, i + 1)).items()} for i in range(STEPS)]
    return flat, batches


@pytest.mark.parametrize("version", [0, 1])
def test_train_matches_jax(version, tmp_path):
    argv = ["train", "--steps", str(STEPS), "--batch", str(B), "--players",
            str(N), "--lr", str(LR), "--seed", str(SEED), "--eval-batches",
            "1", "--log-every", "1", "--out-dir", str(tmp_path),
            "--device", "cpu"] + (["--v1"] if version else [])
    flat, batches = jax_start(version)
    module = PoseRelationModule(**(ttrain.V1_KWARGS if version else {}))
    module.load_state_dict(convert.relation_state_dict_from_flat(flat))
    before = []

    def feed():
        for b in batches:       # the weights each step starts from
            before.append(convert.relation_flat_from_module(module))
            yield b

    out = tr.cmd_train(tr.parse_args(argv), relation=module,
                       batches=feed())
    jrelation, jparams, jhistory = jtrain.train_relation(
        jax.random.PRNGKey(SEED), steps=STEPS, b=B, n_players=N, lr=LR,
        lift_dim=1024 if version else None, log_every=1, verbose=False)

    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    gaps = []
    for i, (got, want) in enumerate(zip(out["history"], jhistory)):
        # JAX's losses on the weights the port's step started from: the
        # same as JAX's run's until an update has moved a scalar by Adam's
        # sign flip (the first update has rate 0).
        jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batches[i].items()}
        refined = jrelation.apply(nest(before[i]), jb["rotmats_noisy"],
                                  jb["boxes"], jb["mask"])
        m = jb["mask"][..., None, None, None]
        denom = max(float(jb["mask"].sum()), 1.0) * 216.0
        on_port = {"loss": float(jax.numpy.sum(jax.numpy.where(
            m, refined - jb["rotmats_gt"], 0.0) ** 2) / denom),
            "input_mse": want["input_mse"]}
        for k in ("loss", "input_mse"):
            assert abs(got[k] - on_port[k]) <= LOSS_REL * abs(on_port[k]), (
                i, k, got, on_port)
        gaps.append(abs(got["loss"] - want["loss"]) / abs(want["loss"]))
    assert gaps[0] <= LOSS_REL and gaps[1] <= LOSS_REL, gaps
    print("relation v%d: loss gaps to JAX's run by step %s"
          % (version, gaps))
    tag = "v%d" % version
    path = str(tmp_path / ("relation_%s.npz" % tag))
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["relation_%s.npz" % tag, "relation_%s_eval.json" % tag])
    with open(tmp_path / ("relation_%s_eval.json" % tag)) as f:
        record = json.load(f)
    assert record["variant"] == tag and record["steps"] == STEPS
    assert record["mse_out"] > 0 and record["weights"] == path

    got = convert.relation_flat_from_module(module)
    want = convert.flatten_tree({"params": jax.device_get(
        jparams["params"])})
    assert set(got) == set(want)
    flips = total = 0
    for k in want:
        gap = np.abs(got[k] - want[k])
        far = gap > PARAM_TOL
        assert (gap[far] <= 2 * LR + PARAM_TOL).all(), k
        flips += int(far.sum())
        total += gap.size
    print("relation %s: %d Adam sign flips of %d scalars over %d steps"
          % (tag, flips, total, STEPS))
    assert flips <= 0.01 * total

    # JAX reads the written weights into the port's numbers.
    relation = jrel.PoseRelationModule(**(jtrain.V1_KWARGS if version
                                          else {}))
    back = convert.flatten_tree(jax.device_get(jtrain.load_relation_weights(
        path, relation, n_players=N)))
    assert all(np.array_equal(back[k], got[k]) for k in got)


def test_arguments_are_checked():
    with pytest.raises(SystemExit):
        tr.parse_args(["train"])                       # no --out-dir
    with pytest.raises(SystemExit):
        tr.parse_args(["relate", "--out-dir", "x"])    # no --root
    args = tr.parse_args(["relate", "--root", "t", "--out-dir", "x",
                          "--cpu", "--optimize-cam", "--v1"])
    assert args.device == "cpu" and args.optimize_cam and args.v1
