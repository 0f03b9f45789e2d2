"""The port's training driver (``scripts/train_perception_torch.py``)
against the JAX script (``scripts/train_perception.py``) and its own
contract, on the CPU.

* the schedule (``train/optim.py:warmup_cosine_decay``, the script's
  :func:`make_schedule`) against ``optax.warmup_cosine_decay_schedule`` at
  every step of a 40-step run and at steps 0, 299, 300 and 3000 of the
  6000-step default, evaluated in fp64: within SCHED_REL relative; the
  port's Adam under it against ``optax.adam(schedule)`` on a
  small tree over 5 steps of the same seeded gradients: within 1e-6;
* the real-proxy mix resumed at a step (``train/real_data.py:
  mixed_batches(start=...)``) gives JAX's mix from that step on without
  rendering the skipped synthetic batches; the regressor's extracted-batch
  decision is JAX's ``RandomState(seed·1000003 + i)`` rule;
* the extraction cache: keyed (another ``--wh`` or ProxyNet file extracts
  afresh, the same settings replay), and ``--extract-batches 0`` refused
  by argparse;
* the drive: evaluations at every segment boundary, a NaN score never
  best, an evaluation that raises ends the run;
* ``fit3d_cfg`` and ``fit3d_knobs`` equal JAX's ``_fit3d_cfg`` and
  ``_fit3d_knobs`` for the same argv; the scripts refuse to run without a
  card unless asked for the CPU.

The state file is held in ``tests/test_torch_train_perception_state.py``,
a resumed run against an unbroken one in ``_resume.py``, the steps on
JAX's own batches in ``_jax.py``.
"""

import dataclasses
import itertools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from soccerplayershapepose_tpu.train import real_data as jreal  # noqa: E402

from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import real_data as treal  # noqa: E402
from soccerplayershapepose_torch.train.optim import (  # noqa: E402
    Adam, warmup_cosine_decay)

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401
from test_torch_perception_train import proxynet_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_perception as jscript  # noqa: E402
import train_perception_torch as tp  # noqa: E402

SCHED_REL = 1e-7
ADAM_TOL = 1e-6
SMALL = ["--batch", "2", "--wh", "64", "--channels", "8", "--h", "64",
         "--w", "96", "--players", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_args(argv, ckpt=None):
    return tp.parse_args(argv + (["--ckpt-dir", str(ckpt)] if ckpt else [])
                         + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# The schedule and Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,counts", [
    (40, list(range(45))), (6000, [0, 299, 300, 3000])])
def test_schedule_matches_optax(steps, counts):
    """optax's schedule evaluated in fp64 (its fp32 rounding alone is 1e-7
    of the peak), each value within SCHED_REL of it."""
    lr = 3e-5
    args = cpu_args(["regressor", "--steps", str(steps), "--lr", str(lr)],
                    "unused")
    got = tp.make_schedule(args)
    with jax.enable_x64(True):
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr,
            warmup_steps=max(min(300, steps // 10), 1), decay_steps=steps,
            end_value=lr * 0.05)
        want = [float(sched(jnp.asarray(c, jnp.int64))) for c in counts]
    worst = max(abs(got(c) - w) / abs(w) for c, w in zip(counts, want)
                if w)
    print("schedule: worst relative gap %.3g" % worst)
    assert worst <= SCHED_REL
    assert got(0) == want[0] == 0.0


def test_adam_under_the_schedule_matches_optax():
    rs = np.random.RandomState(0)
    tree = {"a": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(5).astype(np.float32)}
    sched = warmup_cosine_decay(0.0, 1e-2, 2, 10, 5e-4)
    tx = optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10,
                                                       5e-4))
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    opt_state = tx.init(jp)
    params = [torch.tensor(tree[k], requires_grad=True) for k in ("a", "b")]
    adam = Adam(params, sched)
    for _ in range(5):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in tree.items()}
        upd, opt_state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, opt_state)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(params, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        adam.step()
    gap = max(float(np.abs(p.detach().numpy() - np.asarray(jp[k])).max())
              for p, k in zip(params, ("a", "b")))
    print("Adam after 5 steps: max gap %.3g" % gap)
    assert gap <= ADAM_TOL and adam.count == 5


# ---------------------------------------------------------------------------
# The real-proxy mix and the extracted-batch decision
# ---------------------------------------------------------------------------

def _reals(n=None):
    for i in itertools.count() if n is None else range(n):
        yield {"real": i}


@pytest.mark.parametrize("n_real", [None, 3])
@pytest.mark.parametrize("start", [0, 7])
def test_mix_resumes_as_jax_mixes(n_real, start):
    steps, seed, p = 24, 5, 0.4
    want = list(itertools.islice(jreal.mixed_batches(
        lambda s: {"synth": s}, _reals(n_real), p_real=p, seed=seed), steps))
    rendered = []

    def synth_fn(s):
        rendered.append(s)
        return {"synth": s}

    got = list(itertools.islice(treal.mixed_batches(
        synth_fn, _reals(n_real), p_real=p, seed=seed, start=start),
        steps - start))
    assert got == want[start:]
    assert min(rendered) >= start
    assert any("real" in b for b in want) and any("synth" in b for b in want)


def test_extracted_decision_is_jax_rule():
    for seed in (0, 3):
        picks = [tp.use_extracted(seed, i, 0.3) for i in range(200)]
        assert picks == [np.random.RandomState(seed * 1000003 + i).rand()
                         < 0.3 for i in range(200)]
        assert 30 < sum(picks) < 90


# ---------------------------------------------------------------------------
# The extraction cache
# ---------------------------------------------------------------------------

class CountingStub:
    """An extractor that finds a box-shaped player in every crop, another
    at each call, and counts its calls."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0

    def __call__(self, images_u8):
        self.calls += 1
        images = np.asarray(images_u8)
        wh = images.shape[1]
        out = []
        for j in range(images.shape[0]):
            rs = np.random.RandomState(j + 10 * self.calls)
            sil = np.zeros((wh, wh), np.uint8)
            sil[wh // 8:-wh // 8, wh // 4 + self.calls:-wh // 4] = 1
            kp = np.concatenate([rs.uniform(4, wh - 4, (17, 2)),
                                 np.ones((17, 1))], -1).astype(np.float32)
            out.append((kp, sil, None))
        return out


def test_extract_batches_below_one_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        tp.parse_args(["regressor", "--ckpt-dir", "x",
                       "--extract-batches", "0"])
    assert e.value.code == 2
    assert "extract-batches" in capsys.readouterr().err


def test_cache_is_keyed(fast_raster, tmp_path):
    pn = [str(tmp_path / n) for n in ("pn_a.npz", "pn_b.npz")]
    for i, path in enumerate(pn):
        np.savez(path, w=np.full(3, i, np.float32))
    cache = str(tmp_path / "cache")
    assets = synthesize_assets()

    def source(*extra):
        args = cpu_args(["regressor", "--extract-cache", cache,
                         "--extract-batches", "2"] + SMALL + list(extra),
                        tmp_path)
        stub = CountingStub()
        return tp.extracted_source(args, assets, torch.device("cpu"),
                                   stub), stub, args

    fn, stub, args = source("--via-proxynet", pn[0])
    first = [fn(i) for i in range(3)]       # slots 0, 1, 0
    assert stub.calls == 2
    assert all(torch.equal(first[0][k], first[2][k]) for k in first[0])
    assert not torch.equal(first[0]["proxy"], first[1]["proxy"])
    again, stub2, _ = source("--via-proxynet", pn[0])
    assert torch.equal(again(0)["proxy"], first[0]["proxy"])
    assert stub2.calls == 0
    dirs = set(os.listdir(cache))
    assert len(dirs) == 1
    with open(os.path.join(cache, dirs.pop(), "key.json")) as f:
        assert json.load(f) == tp.extraction_key(args)
    for extra in (["--via-proxynet", pn[1]],
                  ["--via-proxynet", pn[0], "--wh", "32"]):
        fn3, stub3, _ = source(*extra)
        fn3(0)
        assert stub3.calls == 1, extra
    assert len(os.listdir(cache)) == 3


# ---------------------------------------------------------------------------
# The drive
# ---------------------------------------------------------------------------

def blob_source(i):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            proxynet_batch(i % 3, b=2, wh=32).items()}


def test_drive_keeps_the_best_finite_score(tmp_path):
    args = cpu_args(["drive-proxynet", "--steps", "5", "--segment", "2",
                     "--eval-batches", "1", "--log-every", "0", "--batch",
                     "2", "--wh", "32", "--channels", "8"], tmp_path)
    scores = iter([{"kp_pck@0.10bbox": float("nan"), "mask_mean_iou": 0.9},
                   {"kp_pck@0.10bbox": 0.2, "mask_mean_iou": 0.3},
                   {"kp_pck@0.10bbox": 0.1, "mask_mean_iou": 0.1}])
    seen = []

    def evaluate(a):
        with np.load(os.path.join(a.ckpt_dir, "weights_last.npz")) as z:
            seen.append({k: z[k] for k in z.files})
        return dict(next(scores))

    assert tp.drive(args, "proxynet", batch_fn=blob_source,
                    evaluate=evaluate) == 0
    assert len(seen) == 3                  # after steps 2, 4 and 5
    with open(tmp_path / "best.json") as f:
        best = json.load(f)
    assert best["score"] == pytest.approx(0.5)
    with np.load(tmp_path / "weights_best.npz") as z:
        assert all(np.array_equal(z[k], seen[1][k]) for k in z.files)
    with open(tmp_path / "log.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["eval-proxynet"] * 3

    # A best of NaN left by an earlier run is replaced by a finite score.
    with open(tmp_path / "best.json", "w") as f:
        json.dump({"score": float("nan")}, f)
    args.steps = 6
    scores = iter([{"kp_pck@0.10bbox": 0.0, "mask_mean_iou": 0.05}])
    tp.drive(args, "proxynet", batch_fn=blob_source, evaluate=evaluate)
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["score"] == pytest.approx(0.05)


def test_drive_stops_when_an_evaluation_raises(tmp_path):
    args = cpu_args(["drive-proxynet", "--steps", "4", "--segment", "2",
                     "--eval-batches", "1", "--log-every", "0", "--batch",
                     "2", "--wh", "32", "--channels", "8"], tmp_path)

    def evaluate(a):
        raise RuntimeError("the evaluation failed")

    with pytest.raises(RuntimeError, match="evaluation failed"):
        tp.drive(args, "proxynet", batch_fn=blob_source, evaluate=evaluate)
    with np.load(tmp_path / "state.npz") as z:
        assert int(z["step"]) == 2
    assert not os.path.exists(tmp_path / "best.json")


# ---------------------------------------------------------------------------
# The fit evaluations' settings and the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--fit-iters", "7", "--fit-lr", "0.01", "--conf-weight",
         "--betas-prior", "0.1", "--pose-prior", "0.2", "--ortho-prior",
         "0.3", "--silh-warmup", "4", "--joints2d-scale", "0.5",
         "--wh", "384"]])
def test_fit3d_settings_match_jax(argv):
    args = tp.parse_args(["eval-fit3d", "--weights", "w.npz"] + argv)
    got, want = tp.fit3d_cfg(args), jscript._fit3d_cfg(args)
    common = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)})
    assert {"iters", "proxy_wh", "render_wh", "lr", "betas_prior",
            "silh_warmup_iters", "joints2d_scale"} <= common
    assert {n: getattr(got, n) for n in common} == \
        {n: getattr(want, n) for n in common}
    assert tp.fit3d_knobs(args) == jscript._fit3d_knobs(args)


def test_scripts_refuse_to_run_without_a_card(capsys):
    import train_relation_torch as tr
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert tp.main(["eval-regressor", "--weights", "absent.npz"]) == 2
    assert tr.main(["train", "--out-dir", "absent"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    args = tp.parse_args(["regressor", "--ckpt-dir", "x", "--cpu"])
    assert args.device == "cpu"
    with pytest.raises(SystemExit):
        tp.parse_args(["regressor"])       # no --ckpt-dir
