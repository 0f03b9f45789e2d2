"""Training driver for the perception nets and the regressor, with the
PyTorch port.

The counterpart of ``scripts/train_perception.py``, with its twelve modes
and every one of its flags:

* ``proxynet``, ``detector``, ``regressor``: one segment of training. The
  run resumes from ``<ckpt-dir>/state.npz`` (the JAX script's layout, so
  either package resumes the other's) or, with ``--finetune-from DIR``,
  starts from ``DIR/weights_last.npz`` of either package with Adam fresh;
  it takes up to ``--segment`` steps under Adam with
  ``optax.warmup_cosine_decay_schedule(0, lr, min(300, steps/10), steps,
  0.05 lr)``, checkpoints every ``--save-every`` steps and at the end, and
  exits 10 while steps remain and 0 once ``--steps`` are done. Batch ``i``
  is drawn from generators seeded by :func:`step_seed` of ``(seed, i)``
  alone, so a resumed run draws what an unbroken one draws.
* ``drive-proxynet``, ``drive-detector``, ``drive-regressor``: the
  segments in a loop in this process, the matching evaluation on
  ``weights_last.npz`` after each (``--eval-batches`` > 0), the best
  score's metrics in ``best.json`` and its weights in
  ``weights_best.npz``. An evaluation that raises stops the run.
* ``eval-proxynet``, ``eval-detector``, ``eval-regressor``,
  ``eval-fit3d``, ``eval-fit3d-mv``, ``eval-fit3d-track``: one held-out
  evaluation, printed as one JSON line (and written to ``--json``).

Synthetic batches come from ``train/synth.py`` and ``train/straps.py``
(the z-buffer kernel renders them on the card); ProxyNet can mix in
real-proxy batches (``--real-image-root``) and the regressor can train on
proxies extracted by a ProxyNet (``--via-proxynet``), cached on disk under
a key of everything that decides them (``--extract-cache``).

Runs on the CUDA card unless ``--device cpu`` (or ``--cpu``) is given;
without a card it exits non-zero.

    python3 scripts/train_perception_torch.py drive-regressor --steps 1500 \\
        --batch 16 --wh 256 --lr 3e-5 --segment 100 \\
        --via-proxynet weights/proxynet_256_f16.npz \\
        --finetune-from weights/regressor_warm --ckpt-dir /tmp/regressor
    python3 scripts/train_perception_torch.py eval-regressor \\
        --weights weights/regressor_r05/weights_last.npz --wh 512
    python3 scripts/train_perception_torch.py proxynet --steps 4 \\
        --segment 2 --batch 2 --wh 64 --channels 8 --ckpt-dir /tmp/pn \\
        --device cpu        # a small run on the CPU
"""

import argparse
import hashlib
import json
import math
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEGMENT_RC = 10          # segment finished, more steps remain
KINDS = ("proxynet", "detector", "regressor")
MODES = KINDS + tuple("drive-" + k for k in KINDS) + (
    "eval-proxynet", "eval-detector", "eval-regressor", "eval-fit3d",
    "eval-fit3d-mv", "eval-fit3d-track")
EXTRACT_SLOT_BASE = 777_000   # cache slot s draws as step 777_000 + s


def _positive_int(text):
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError("must be at least 1, got %d"
                                         % value)
    return value


def build_parser():
    p = argparse.ArgumentParser(
        description="Train and evaluate the perception nets and the "
                    "regressor (PyTorch port of scripts/train_perception.py)")
    p.add_argument("mode", choices=MODES)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--segment", type=int, default=400)
    p.add_argument("--segment-timeout", type=int, default=2400,
                   help="accepted for the JAX script's command lines; no "
                        "effect here (segments run in this process)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--wh", type=int, default=256)
    p.add_argument("--h", type=int, default=256)
    p.add_argument("--w", type=int, default=448)
    p.add_argument("--players", type=int, default=8)
    p.add_argument("--views", type=int, default=3,
                   help="eval-fit3d-mv: cameras per player")
    p.add_argument("--frames", type=int, default=8,
                   help="eval-fit3d-track: clip length per player")
    p.add_argument("--mv-rounds", type=int, default=3,
                   help="eval-fit3d-mv: alternation rounds (reference 3)")
    p.add_argument("--mv-iters", type=int, default=50,
                   help="eval-fit3d-mv: iters per phase (reference 50)")
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--save-every", type=int, default=200,
                   help="in-segment checkpoint interval (0 = segment end "
                        "only)")
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--no-iuv", action="store_true")
    p.add_argument("--no-occluders", action="store_true")
    p.add_argument("--resnet-layers", type=int, default=18, choices=[18, 50],
                   help="regressor encoder depth (18 or 50)")
    p.add_argument("--proxy-channels", type=int, default=18,
                   choices=[18, 20, 21],
                   help="regressor proxy input: 18 = [sil, heatmaps]; 21 "
                        "adds IUV; 20 = [heatmaps, IUV]")
    p.add_argument("--no-corrupt", action="store_true",
                   help="regressor ablation: train on clean GT proxies "
                        "(no STRAPS-style corruption)")
    p.add_argument("--eval-corrupt", action="store_true",
                   help="evaluate the regressor under the corruption noise "
                        "model instead of clean proxies")
    p.add_argument("--via-proxynet", default=None,
                   help="ProxyNet weights .npz: train the regressor on, or "
                        "evaluate it through, proxies the ProxyNet extracts "
                        "from RGB crops")
    p.add_argument("--fit-iters", type=int, default=0,
                   help="eval-fit3d*: override the 100-iteration budget "
                        "(0 = 100)")
    p.add_argument("--fit-lr", type=float, default=0.001,
                   help="eval-fit3d*: the fit's Adam lr (reference 0.001)")
    p.add_argument("--conf-weight", action="store_true",
                   help="eval-fit3d*: weight the joints-2D fit loss by the "
                        "keypoint score channel")
    p.add_argument("--betas-prior", type=float, default=0.0)
    p.add_argument("--pose-prior", type=float, default=0.0)
    p.add_argument("--ortho-prior", type=float, default=0.0)
    p.add_argument("--joints2d-scale", type=float, default=1.0)
    p.add_argument("--silh-warmup", type=int, default=0,
                   help="eval-fit3d*: silhouette-loss linear warmup iters")
    p.add_argument("--no-domain-rand", action="store_true",
                   help="ablation baseline: plain background, no blur or "
                        "photometric jitter")
    p.add_argument("--eval-easy", action="store_true",
                   help="eval-proxynet on the non-randomised held-out set")
    p.add_argument("--flip-tta", action="store_true",
                   help="horizontal-flip ensemble in the extractor "
                        "(evaluations, and the regressor's extracted "
                        "batches) and the detector's evaluation")
    p.add_argument("--kp-tta-tau", type=float, default=0.08,
                   help="keypoint TTA agreement radius (fraction of the "
                        "crop size)")
    p.add_argument("--kp-disagree-penalty", type=float, default=1.0,
                   help="keypoint TTA score factor where the passes "
                        "disagree")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (required for training; eval modes "
                        "may instead pass --weights)")
    p.add_argument("--real-image-root", default=None,
                   help="crop tree mixed into ProxyNet's batches")
    p.add_argument("--real-proxy-root", default=None)
    p.add_argument("--p-real", type=float, default=0.3)
    p.add_argument("--extract-cache", default=None,
                   help="regressor --via-proxynet: directory caching the "
                        "extracted batches, one sub-directory per key of "
                        "the settings and ProxyNet weights that decide them")
    p.add_argument("--extract-batches", type=_positive_int, default=48,
                   help="number of cache slots (distinct extracted batches)")
    p.add_argument("--finetune-from", default=None,
                   help="directory whose weights_last.npz starts the run "
                        "(Adam fresh) when no state.npz is there")
    p.add_argument("--weights", default=None)
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card)")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    return p


def parse_args(argv=None):
    """The parsed flags, ``--cpu`` folded into ``--device``; a missing
    checkpoint directory or weights file is an argparse error."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.mode.startswith("eval-"):
        if not (args.weights or args.ckpt_dir):
            p.error("eval modes need --weights or --ckpt-dir")
    elif not args.ckpt_dir:
        p.error("--ckpt-dir is required for training")
    return args


# ---------------------------------------------------------------------------
# Schedule, seeds and the state file
# ---------------------------------------------------------------------------

def make_schedule(args):
    """The JAX script's rate: a linear warmup over min(300, steps / 10)
    steps (at least 1) to ``lr``, then a cosine to 0.05 lr at ``steps``;
    read at Adam's count before the step (``train/optim.py``)."""
    from soccerplayershapepose_torch.train.optim import warmup_cosine_decay
    return warmup_cosine_decay(0.0, args.lr,
                               max(min(300, args.steps // 10), 1),
                               args.steps, args.lr * 0.05)


def step_seed(seed, i):
    """The seed of step ``i``'s batch generators: a fixed function of
    ``seed + 1`` and ``i`` only."""
    return ((seed + 1) << 32) + i


def step_generators(seed, i, dev):
    """(CPU generator for the geometry, generator on ``dev`` for the
    appearance), both seeded :func:`step_seed`."""
    import torch
    s = step_seed(seed, i)
    return (torch.Generator().manual_seed(s),
            torch.Generator(device=dev).manual_seed(s))


def use_extracted(seed, i, p_real):
    """Whether regressor step ``i`` trains on an extracted batch: the JAX
    script's per-step decision."""
    import numpy as np
    return np.random.RandomState(seed * 1000003 + i).rand() < p_real


def _net(state):
    return state.regressor if hasattr(state, "regressor") else state.model


def _variables_flat(state):
    """The net's ``params/…`` and ``batch_stats/…`` (flax names and
    layouts, fp32 numpy): ``weights_last.npz``."""
    from soccerplayershapepose_torch import convert
    net = _net(state)
    if hasattr(state, "regressor"):
        return convert.regressor_flat_from_state_dict(net.state_dict(),
                                                      net.resnet_layers)
    return convert.proxynet_flat_from_state_dict(net.state_dict())


def _moment_keys(state):
    """The path under ``opt_state/0/.mu/`` of each of Adam's tensors, in
    its order: the parameters' flax paths, and for the regressor
    ``0/<path>`` then ``1/<task>`` (optax's state of the tuple (params,
    log_vars))."""
    from soccerplayershapepose_torch import convert
    net = _net(state)
    if hasattr(state, "regressor"):
        names = [convert.regressor_flax_name(n, net.resnet_layers)
                 for n, _ in net.named_parameters()]
        return (["0/" + n[len("params/"):] for n in names]
                + ["1/" + t for t in state.log_vars])
    return [convert.perception_flax_name(n)[len("params/"):]
            for n, _ in net.named_parameters()]


def state_flat(state):
    """The train state as the JAX script's ``_save_state`` flattens it:
    ``params/…``, ``batch_stats/…``, ``log_vars/<task>`` (the regressor),
    ``opt_state/0/.count``, ``opt_state/0/.mu/…``, ``opt_state/0/.nu/…``,
    ``opt_state/1/.count`` (the schedule's count) and ``step``."""
    import numpy as np
    from soccerplayershapepose_torch.convert import to_flax_layout
    flat = _variables_flat(state)
    if hasattr(state, "regressor"):
        for task, v in state.log_vars.items():
            flat["log_vars/" + task] = v.detach().cpu().numpy().copy()
    for which, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        for key, m in zip(_moment_keys(state), moments):
            a = m.detach().cpu().numpy().copy()
            flat["opt_state/0/.%s/%s" % (which, key)] = (
                to_flax_layout(a) if key.endswith("/kernel") else a)
    count = np.asarray(state.opt.count, np.int32)
    flat["opt_state/0/.count"] = count
    flat["opt_state/1/.count"] = count.copy()
    flat["step"] = np.asarray(state.step, np.int32)
    return flat


def _save_npz(path, flat):
    """``np.savez`` through a ``.tmp.npz`` file renamed into place."""
    import numpy as np
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_state(path, state):
    _save_npz(path, state_flat(state))


def save_weights(path, state):
    """The net's inference weights in the JAX script's ``weights_last.npz``
    layout (``params/…``, ``batch_stats/…``)."""
    _save_npz(path, _variables_flat(state))


def _load_variables(net, flat, path):
    """``net``'s parameters and BN statistics from flat flax variables,
    strictly; the other collections of a state file (and a regressor's
    ``log_vars/``) are left out."""
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.models.detector import PlayerDetector
    from soccerplayershapepose_torch.models.regressor import (
        SingleInputRegressor)
    flat = {k: v for k, v in flat.items()
            if k.startswith(("params/", "batch_stats/"))}
    if isinstance(net, SingleInputRegressor):
        sd = convert.regressor_state_dict_from_flat(flat)
    elif isinstance(net, PlayerDetector):
        sd = convert.detector_state_dict_from_flat(flat)
    else:
        sd = convert.proxynet_state_dict_from_flat(flat)
    convert._load_strict(net, sd, path, type(net).__name__)


def _read_npz(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_state(path, state):
    """Restore ``state`` in place from a ``state.npz`` of either package:
    the net, the log-variances (the regressor), Adam's moments and count,
    the step. Returns ``state``."""
    import numpy as np
    import torch
    from soccerplayershapepose_torch.convert import from_flax_layout
    flat = _read_npz(path)
    with torch.no_grad():
        _load_variables(_net(state), flat, path)
        if hasattr(state, "regressor"):
            for task, v in state.log_vars.items():
                v.copy_(torch.from_numpy(np.array(flat["log_vars/" + task],
                                                  np.float32)))
        for which, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
            for key, m in zip(_moment_keys(state), moments):
                a = np.array(flat["opt_state/0/.%s/%s" % (which, key)],
                             np.float32)
                if key.endswith("/kernel"):
                    a = from_flax_layout(a)
                m.copy_(torch.from_numpy(np.ascontiguousarray(a))
                        .reshape(m.shape))
    state.opt.count = int(flat["opt_state/0/.count"])
    state.step = int(flat["step"])
    return state


def finetune_from(state, directory):
    """The net's parameters and BN statistics from
    ``<directory>/weights_last.npz`` (either package's); Adam untouched."""
    import torch
    src = os.path.join(directory, "weights_last.npz")
    with torch.no_grad():
        _load_variables(_net(state), _read_npz(src), src)


# ---------------------------------------------------------------------------
# Models and batches
# ---------------------------------------------------------------------------

def new_state(args, kind, dev):
    """A fresh train state of ``kind`` on ``dev``: flax's initialisers drawn
    from a CPU generator seeded ``--seed``, Adam under
    :func:`make_schedule`."""
    import torch
    from soccerplayershapepose_torch.train import distill
    from soccerplayershapepose_torch.train import perception as ptrain
    sched = make_schedule(args)
    gen = torch.Generator().manual_seed(args.seed)
    if kind == "proxynet":
        return ptrain.make_perception_state(ptrain.new_proxynet(
            gen, not args.no_iuv, dev, args.channels), sched)
    if kind == "detector":
        return ptrain.make_perception_state(ptrain.new_detector(
            gen, dev, args.channels), sched)
    return distill.make_train_state(distill.new_regressor(
        args.proxy_channels, args.seed, dev, args.resnet_layers),
        learning_rate=sched)


def make_step(kind):
    """``step(state, assets, batch) → losses`` (detached, with ``total``)."""
    from soccerplayershapepose_torch.train import distill
    from soccerplayershapepose_torch.train import perception as ptrain
    if kind == "regressor":
        base = distill.make_train_step()

        def regressor_step(state, assets, batch):
            _, metrics, _ = base(state, assets, batch)
            metrics = dict(metrics)
            return {"total": metrics.pop("loss"), **metrics}
        return regressor_step
    step = (ptrain.make_proxynet_train_step() if kind == "proxynet"
            else ptrain.make_detector_train_step())
    return lambda state, assets, batch: step(state, batch)[1]


def to_device(batch, dev):
    """A batch's numpy arrays and tensors as tensors on ``dev``."""
    import numpy as np
    import torch
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
        v, np.ndarray) else v).to(dev) for k, v in batch.items()}


def extraction_key(args):
    """Everything that decides an extracted batch: the crop size, the
    batch, the proxy width, ProxyNet's width, IUV head and flip TTA, the
    seed and the ProxyNet weights file's bytes (SHA-256)."""
    with open(args.via_proxynet, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"wh": args.wh, "batch": args.batch,
            "proxy_channels": args.proxy_channels, "channels": args.channels,
            "no_iuv": bool(args.no_iuv), "flip_tta": bool(args.flip_tta),
            "seed": args.seed, "proxynet_sha256": digest}


def cache_dir(root, key):
    """``<root>/<hash of key>/``, made with a ``key.json`` that names it:
    slots extracted under other settings or weights are never replayed."""
    name = hashlib.sha256(json.dumps(key, sort_keys=True).encode()
                          ).hexdigest()[:16]
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "key.json")
    if not os.path.exists(path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(key, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return d


def cached_raw(directory, slot, make_raw):
    """Slot ``slot``'s raw extracted batch: ``make_raw()`` written to
    ``batch_<slot>.npz`` the first time, and read back from the file every
    time (the first too, so a replay gives what the first use gave)."""
    import numpy as np
    path = os.path.join(directory, "batch_%05d.npz" % slot)
    if not os.path.exists(path):
        _save_npz(path, make_raw())
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def batch_source(args, kind, assets, dev, start):
    """``batch(i)`` of the synthetic factory (and the real-proxy mix or the
    extracted batches) for a run resumed at step ``start``."""
    from soccerplayershapepose_torch.train import straps, synth
    if kind == "proxynet":
        def synth_fn(i):
            gen, image_gen = step_generators(args.seed, i, dev)
            return synth.render_crop_batch(assets, synth.sample_crop_draws(
                gen, args.batch, image_wh=args.wh,
                domain_rand=not args.no_domain_rand,
                occluders=not args.no_occluders, image_gen=image_gen),
                args.wh, with_image=True)
        if not args.real_image_root:
            return synth_fn
        from soccerplayershapepose_torch.train import real_data
        real = real_data.proxy_tree_batches(
            args.real_image_root,
            args.real_proxy_root or args.real_image_root, batch=args.batch,
            wh=args.wh, seed=args.seed)
        mixer = real_data.mixed_batches(synth_fn, real, p_real=args.p_real,
                                        seed=args.seed, start=start)
        return lambda i: to_device(next(mixer), dev)
    if kind == "detector":
        def frames(i):
            gen, image_gen = step_generators(args.seed, i, dev)
            return synth.render_frame_batch(assets, synth.sample_frame_draws(
                gen, args.batch, args.players, (args.h, args.w),
                image_gen=image_gen), (args.h, args.w))
        return frames

    def synthetic(i):
        gen, _ = step_generators(args.seed, i, dev)
        return straps.synth_regressor_batch(
            assets, straps.sample_regressor_draws(
                gen, args.batch, args.wh, corrupt=not args.no_corrupt,
                occluders=not args.no_occluders), wh=args.wh,
            proxy_channels=args.proxy_channels)
    if not args.via_proxynet:
        return synthetic
    extracted = extracted_source(args, assets, dev)

    def mixed(i):
        if use_extracted(args.seed, i, args.p_real):
            return extracted(i)
        return synthetic(i)
    return mixed


def extracted_source(args, assets, dev, extractor=None):
    """``batch(i)`` of proxies extracted by ``--via-proxynet`` (or
    ``extractor``): step ``i``'s own crops, or with ``--extract-cache``
    the raw batch of slot ``i % --extract-batches``, extracted once from
    the crops of step :data:`EXTRACT_SLOT_BASE` + slot and replayed."""
    from soccerplayershapepose_torch.train import straps
    if extractor is None:
        from soccerplayershapepose_torch.models.perception import ProxyNet
        from soccerplayershapepose_torch.pipeline.extract import (
            ProxyExtractor)
        from soccerplayershapepose_torch.train.perception import (
            load_perception_weights)
        pnet = load_perception_weights(args.via_proxynet, ProxyNet(
            with_iuv=not args.no_iuv, channels=args.channels))
        extractor = ProxyExtractor(pnet, wh=args.wh, flip_tta=args.flip_tta,
                                   device=dev)

    def draws(i):
        gen, image_gen = step_generators(args.seed, i, dev)
        return straps.sample_extracted_draws(gen, args.batch, args.wh,
                                             image_gen=image_gen)

    if not args.extract_cache:
        return lambda i: straps.extracted_regressor_batch(
            assets, extractor, draws(i), wh=args.wh,
            proxy_channels=args.proxy_channels)
    directory = cache_dir(args.extract_cache, extraction_key(args))

    def cached(i):
        slot = i % args.extract_batches
        raw = cached_raw(directory, slot, lambda: straps.
                         extracted_regressor_batch(
                             assets, extractor,
                             draws(EXTRACT_SLOT_BASE + slot), wh=args.wh,
                             proxy_channels=args.proxy_channels,
                             return_raw=True))
        return straps.assemble_extracted_batch(raw, args.wh,
                                               args.proxy_channels, dev)
    return cached


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _log(ckpt_dir, record):
    with open(os.path.join(ckpt_dir, "log.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


class Trainer:
    """A run's state, assets, step and batches on the device, resumed from
    ``<ckpt-dir>/state.npz`` or warm-started (``--finetune-from``).
    ``batch_fn(i)`` replaces the synthetic source; ``stage_times``, a
    dict, receives the synchronised wall seconds of ``batch`` and
    ``step``."""

    def __init__(self, args, kind, batch_fn=None, stage_times=None):
        from soccerplayershapepose_torch.pipeline.predict import on_device
        from soccerplayershapepose_torch.smpl import load_assets
        from soccerplayershapepose_torch.utils.precision import (
            default_device)
        self.args, self.kind = args, kind
        self.dev = default_device(args.device)
        self.stage_times = stage_times
        os.makedirs(args.ckpt_dir, exist_ok=True)
        self.state_path = os.path.join(args.ckpt_dir, "state.npz")
        self.assets = on_device(load_assets(), self.dev)
        self.state = new_state(args, kind, self.dev)
        if os.path.exists(self.state_path):
            load_state(self.state_path, self.state)
        elif args.finetune_from:
            finetune_from(self.state, args.finetune_from)
        self.step_fn = make_step(kind)
        self.batch_fn = batch_fn or batch_source(
            args, kind, self.assets, self.dev, self.state.step)

    def checkpoint(self):
        save_state(self.state_path, self.state)
        save_weights(os.path.join(self.args.ckpt_dir, "weights_last.npz"),
                     self.state)

    def run(self, end):
        """Steps ``state.step`` .. ``end`` − 1, logged every
        ``--log-every``, checkpointed every ``--save-every`` and at the
        end."""
        from soccerplayershapepose_torch.train.straps import _lap
        args, kind = self.args, self.kind
        start = self.state.step
        t0 = time.time()
        t = _lap(self.stage_times, "batch", time.perf_counter(), self.dev)
        losses = None
        for i in range(start, end):
            batch = to_device(self.batch_fn(i), self.dev)
            t = _lap(self.stage_times, "batch", t, self.dev)
            losses = self.step_fn(self.state, self.assets, batch)
            t = _lap(self.stage_times, "step", t, self.dev)
            if args.log_every and (i + 1) % args.log_every == 0:
                vals = {k: float(v) for k, v in losses.items()}
                rate = (i + 1 - start) / (time.time() - t0)
                print(f"{kind} step {i + 1}/{args.steps}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                      + f" ({rate:.2f} steps/s)", flush=True)
                _log(args.ckpt_dir, {"kind": kind, "step": i + 1, **vals,
                                     "steps_per_s": rate})
            if args.save_every and (i + 1) % args.save_every == 0 \
                    and (i + 1) < end:
                self.checkpoint()
        self.checkpoint()
        print(f"{kind}: segment done at step {self.state.step}", flush=True)
        return losses


def train_segment(args, kind, batch_fn=None, stage_times=None):
    """One segment: returns 0 when ``--steps`` are done, else
    :data:`SEGMENT_RC`."""
    trainer = Trainer(args, kind, batch_fn, stage_times)
    start = trainer.state.step
    if start >= args.steps:
        print(f"{kind}: training complete at step {start}")
        return 0
    trainer.run(min(start + args.segment, args.steps))
    return 0 if trainer.state.step >= args.steps else SEGMENT_RC


def score(kind, metrics):
    """The drive's score (higher is better): ProxyNet PCK@0.1 + mask IoU,
    the regressor −PVE, the detector AP@0.5."""
    if kind == "proxynet":
        return (metrics.get("kp_pck@0.10bbox") or 0.0) \
            + (metrics.get("mask_mean_iou") or 0.0)
    if kind == "regressor":
        return -(metrics.get("pve_mm") or 1e9)
    return metrics.get("ap@0.5") or 0.0


def drive(args, kind, batch_fn=None, evaluate=None, stage_times=None):
    """The segments in a loop in this process, each followed (with
    ``--eval-batches`` > 0) by ``evaluate(args)`` (default the
    ``eval-<kind>`` mode) on ``weights_last.npz``; a finite score above the
    best so far is kept in ``best.json`` and ``weights_best.npz``. An
    evaluation that raises ends the run with its exception. Returns 0."""
    evaluate = evaluate or EVALS[kind]
    best_path = os.path.join(args.ckpt_dir, "best.json")
    best = None
    if os.path.exists(best_path):
        with open(best_path) as f:
            best = json.load(f)
    trainer = Trainer(args, kind, batch_fn, stage_times)
    while True:
        start = trainer.state.step
        if start >= args.steps:
            print(f"{kind}: training complete at step {start}")
        else:
            trainer.run(min(start + args.segment, args.steps))
        done = trainer.state.step >= args.steps
        if args.eval_batches > 0:
            metrics = evaluate(args)
            write_json(args, metrics)
            s = score(kind, metrics)
            _log(args.ckpt_dir, {"kind": f"eval-{kind}", **metrics})
            print("eval:", json.dumps(metrics), flush=True)
            # A NaN score (every extraction failed on an early evaluation)
            # never becomes the best: it would win no comparison after.
            if not math.isfinite(s):
                print("eval score non-finite; not tracked", flush=True)
            elif (best is None
                  or not math.isfinite(best.get("score", float("nan")))
                  or s > best["score"]):
                best = {"score": s, **metrics}
                with open(best_path, "w") as f:
                    json.dump(best, f, indent=1)
                shutil.copyfile(
                    os.path.join(args.ckpt_dir, "weights_last.npz"),
                    os.path.join(args.ckpt_dir, "weights_best.npz"))
                print(f"new best score {s:.4f}", flush=True)
        if done:
            print("drive: training complete", flush=True)
            return 0


# ---------------------------------------------------------------------------
# Evaluations
# ---------------------------------------------------------------------------

def _weights(args):
    return args.weights or os.path.join(args.ckpt_dir, "weights_last.npz")


def _assets(dev):
    from soccerplayershapepose_torch.pipeline.predict import on_device
    from soccerplayershapepose_torch.smpl import load_assets
    return on_device(load_assets(), dev)


def _proxynet(path, args, dev):
    from soccerplayershapepose_torch.models.perception import ProxyNet
    from soccerplayershapepose_torch.train.perception import (
        load_perception_weights)
    return load_perception_weights(path, ProxyNet(
        with_iuv=not args.no_iuv, channels=args.channels)).to(dev)


def load_regressor(path, in_channels, resnet_layers, dev):
    """The regressor of a flat npz of either package (a ``log_vars/``
    collection left out), in eval mode; its input width and depth must be
    the ones asked for."""
    from soccerplayershapepose_torch.convert import load_regressor_weights
    net = load_regressor_weights(path, dev)
    if (net.in_channels, net.resnet_layers) != (in_channels, resnet_layers):
        raise ValueError("%s holds a %d-channel ResNet-%d regressor, not "
                         "%d channels, ResNet-%d" % (
                             path, net.in_channels, net.resnet_layers,
                             in_channels, resnet_layers))
    return net


def eval_proxynet(args):
    from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
    from soccerplayershapepose_torch.train.quality import evaluate_proxynet
    from soccerplayershapepose_torch.utils.precision import default_device
    dev = default_device(args.device)
    weights = _weights(args)
    ex = ProxyExtractor(_proxynet(weights, args, dev), wh=args.wh,
                        flip_tta=args.flip_tta, kp_tta_tau=args.kp_tta_tau,
                        kp_disagree_penalty=args.kp_disagree_penalty,
                        device=dev)
    out = evaluate_proxynet(ex, _assets(dev), n_batches=args.eval_batches,
                            batch=args.batch, wh=args.wh,
                            occluders=not args.no_occluders,
                            domain_rand=not args.eval_easy)
    out["weights"] = weights
    return out


def eval_detector(args):
    from soccerplayershapepose_torch.models.detector import PlayerDetector
    from soccerplayershapepose_torch.train.perception import (
        load_perception_weights)
    from soccerplayershapepose_torch.train.quality import evaluate_detector
    from soccerplayershapepose_torch.utils.precision import default_device
    dev = default_device(args.device)
    weights = _weights(args)
    model = load_perception_weights(weights, PlayerDetector(
        channels=args.channels)).to(dev)
    out = evaluate_detector(model, _assets(dev), n_batches=args.eval_batches,
                            batch=args.batch, hw=(args.h, args.w),
                            n_players=args.players, flip_tta=args.flip_tta,
                            device=dev)
    out["weights"] = weights
    return out


def eval_regressor(args):
    from soccerplayershapepose_torch.train import straps
    from soccerplayershapepose_torch.utils.precision import default_device
    dev = default_device(args.device)
    weights = _weights(args)
    model = load_regressor(weights, args.proxy_channels, args.resnet_layers,
                           dev)
    assets = _assets(dev)
    if args.via_proxynet:
        # The deployment chain: RGB crop → ProxyNet and the extractor →
        # proxy → regressor → 3-D error.
        from soccerplayershapepose_torch.pipeline.extract import (
            ProxyExtractor)
        ex = ProxyExtractor(_proxynet(args.via_proxynet, args, dev),
                            wh=args.wh, flip_tta=args.flip_tta, device=dev)
        out = straps.evaluate_regressor_e2e(
            model, ex, assets, n_batches=args.eval_batches,
            batch=args.batch, wh=args.wh, device=dev)
        out["proxynet_weights"] = args.via_proxynet
    else:
        out = straps.evaluate_regressor(
            model, assets, n_batches=args.eval_batches, batch=args.batch,
            wh=args.wh, corrupt=args.eval_corrupt, device=dev)
    out["proxy_channels"] = args.proxy_channels
    out["weights"] = weights
    return out


def fit3d_cfg(args):
    """The GT-3D evaluations' fit: the JAX script's ``_fit3d_cfg``."""
    from soccerplayershapepose_torch.fit.engine import FitConfig
    return FitConfig(
        iters=args.fit_iters or 100, proxy_wh=args.wh,
        render_wh=min(args.wh, 256), lr=args.fit_lr,
        joint_conf_weighting=args.conf_weight,
        betas_prior=args.betas_prior, pose_prior=args.pose_prior,
        rot_ortho_prior=args.ortho_prior,
        silh_warmup_iters=args.silh_warmup,
        joints2d_scale=args.joints2d_scale)


def fit3d_knobs(args):
    return {"lr": args.fit_lr, "conf_weight": args.conf_weight,
            "betas_prior": args.betas_prior, "pose_prior": args.pose_prior,
            "ortho_prior": args.ortho_prior,
            "silh_warmup": args.silh_warmup,
            "joints2d_scale": args.joints2d_scale,
            "prior_scale": "relative (r4c: anchored to stop_grad|total|)"}


def _eval_fit(args, evaluate, **kw):
    """An 18-channel regressor's GT-3D fit evaluation (``evaluate`` with
    the fit of :func:`fit3d_cfg`)."""
    from soccerplayershapepose_torch.utils.precision import default_device
    dev = default_device(args.device)
    weights = _weights(args)
    model = load_regressor(weights, 18, args.resnet_layers, dev)
    out = evaluate(model, _assets(dev), n_batches=args.eval_batches,
                   batch=args.batch, wh=args.wh,
                   corrupt=not args.no_corrupt, fit_cfg=fit3d_cfg(args),
                   device=dev, **kw)
    out["weights"] = weights
    out["fit_knobs"] = fit3d_knobs(args)
    return out


def eval_fit3d(args):
    from soccerplayershapepose_torch.train.straps import evaluate_fit_3d
    return _eval_fit(args, evaluate_fit_3d)


def eval_fit3d_mv(args):
    from soccerplayershapepose_torch.train.fit3d import (
        evaluate_fit_3d_multiview)
    return _eval_fit(args, evaluate_fit_3d_multiview, n_views=args.views,
                     rounds=args.mv_rounds, iters_per_phase=args.mv_iters)


def eval_fit3d_track(args):
    from soccerplayershapepose_torch.train.fit3d import evaluate_fit_3d_track
    return _eval_fit(args, evaluate_fit_3d_track, n_frames=args.frames)


EVALS = {"proxynet": eval_proxynet, "detector": eval_detector,
         "regressor": eval_regressor, "fit3d": eval_fit3d,
         "fit3d-mv": eval_fit3d_mv, "fit3d-track": eval_fit3d_track}


def write_json(args, out):
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


def main(argv=None):
    args = parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("train_perception_torch: CUDA is not available; pass "
              "--device cpu (or --cpu) to run on the CPU", file=sys.stderr)
        return 2
    if args.mode in KINDS:
        return train_segment(args, args.mode)
    if args.mode.startswith("drive-"):
        return drive(args, args.mode.split("-", 1)[1])
    out = EVALS[args.mode.split("-", 1)[1]](args)
    print(json.dumps(out), flush=True)
    write_json(args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
