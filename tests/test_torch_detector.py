"""The port's PlayerDetector, its decode and its runner against the JAX
package.

Tolerances:

* the detector on the committed ``weights/detector_256x448_f16.npz`` at
  64×96, and its flip-TTA merge: ≤ 1e-4 max abs on every head (fp32
  convolutions summed in another order; ProxyNet's bar);
* ``decode_detections`` on seeded maps whose centre logits hold plateaus
  of equal values (equal-score peaks) and far fewer peaks than K slots
  (zero-score tails): scores exact and boxes ≤ 1e-5 max abs, slot by
  slot, so the slot order is JAX's; with and without the box NMS. The
  same maps through ``torch.topk`` give other boxes in the zero-score
  slots, which is why the port sorts;
* the runner (uint8 frames → boxes scoring ≥ 0.7) on synthetic 256×448
  frames, with and without flip TTA: the kept boxes ≤ 1e-3 px apart (a
  box corner is 4 · (cell + offset) ± size / 2, and the offsets and sizes
  carry the heads' 1e-4 gap at a few px), and a box kept by one package
  only where its score lies within 1e-4 of the threshold (counted).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.pipeline import (  # noqa: E402
    extract as jextract)

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models import detector as tdet  # noqa: E402
from soccerplayershapepose_torch.models.perception import (  # noqa: E402
    ProxyNet)
from soccerplayershapepose_torch.pipeline import (  # noqa: E402
    extract as textract)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import (  # noqa: E402
    fast_rasterize_attributes, nest_flat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "detector_256x448_f16.npz")
PROXYNET_512 = os.path.join(REPO, "weights", "proxynet_512_f16.npz")
HEAD_TOL = 1e-4
BOX_TOL = 1e-5
RUNNER_BOX_TOL = 1e-3
NEAR_THRESH = 1e-4
B, H, W = 2, 64, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flat():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_variables(flat):
    return nest_flat(flat)


@pytest.fixture(scope="module")
def port_det():
    return convert.load_detector_weights(WEIGHTS, "cpu")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _check_heads(got, want):
    for name, g, w in zip(tdet.DetectorOutput._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        print("%s: max abs %.3g (values up to %.3g)"
              % (name, err, np.abs(w).max()))
        assert err <= HEAD_TOL, name


def test_detector_heads_match_flax(port_det, jax_variables, images):
    want = jdet.PlayerDetector().apply(jax_variables, jnp.asarray(images),
                                       train=False)
    with torch.no_grad():
        got = port_det(_nchw(images))
    assert got.center_logits.shape == (B, H // 4, W // 4, 1)
    _check_heads(got, want)


def test_flip_tta_matches_jax(port_det, jax_variables, images):
    want = jdet.apply_flip_tta(jdet.PlayerDetector(), jax_variables,
                               jnp.asarray(images))
    with torch.no_grad():
        got = tdet.apply_flip_tta(port_det, _nchw(images))
    _check_heads(got, want)


def test_load_detector_weights_is_strict(flat, tmp_path):
    model = convert.load_detector_weights(WEIGHTS, "cpu")
    assert model.channels == 128 and not model.training
    missing = dict(flat)
    del missing["params/det_tower/Conv_1/bias"]
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(ValueError, match="missing"):
        convert.load_detector_weights(str(tmp_path / "missing.npz"), "cpu")
    extra = dict(flat, **{"params/kp_out/bias": np.zeros(17, np.float16)})
    np.savez(tmp_path / "extra.npz", **extra)
    with pytest.raises(ValueError, match="unexpected"):
        convert.load_detector_weights(str(tmp_path / "extra.npz"), "cpu")


def test_proxynet_without_iuv_drops_only_the_iuv_head(tmp_path):
    """``with_iuv=False`` drops ``iuv_tower``, ``part_out`` and ``uv_out``
    by name and loads every other variable strictly."""
    with np.load(PROXYNET_512) as z:
        flat = {k: z[k] for k in z.files}
    net = convert.load_proxynet_weights(PROXYNET_512, "cpu", with_iuv=False)
    full = convert.load_proxynet_weights(PROXYNET_512, "cpu")
    assert not net.with_iuv and full.with_iuv
    kept = {k: v for k, v in full.state_dict().items()
            if k.split(".")[0] not in convert.IUV_HEAD}
    assert kept.keys() == net.state_dict().keys()
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in kept.items())
    missing = {k: v for k, v in flat.items()
               if k != "params/mask_out/bias"}
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(ValueError, match="missing"):
        convert.load_proxynet_weights(str(tmp_path / "missing.npz"), "cpu",
                                      with_iuv=False)
    assert isinstance(net, ProxyNet)


def seeded_maps(seed, density, b=B, h=16, w=24):
    """Detector maps whose centre logits are 2×2 plateaus of a few levels
    (equal scores; every cell of a plateau that is its 3×3 maximum is a
    peak) on a ``density`` of the blocks, over a floor falling away from the
    corner (no peak but the corner), so far fewer cells are peaks than
    the K slots hold; random sizes and offsets (beyond the [-1, 2] clip
    too)."""
    rng = np.random.RandomState(seed)
    levels = np.array([-1.0, 0.5, 2.0], np.float32)
    blocks = levels[rng.randint(0, len(levels), (b, h // 2, w // 2))]
    on = rng.rand(b, h // 2, w // 2) < density
    yy, xx = np.mgrid[0:h, 0:w]
    floor = (-8.0 - 0.1 * (yy + xx)).astype(np.float32)
    plateau = np.repeat(np.repeat(np.where(on, blocks, -np.inf), 2, 1), 2, 2)
    center = np.maximum(floor, plateau).astype(np.float32)[..., None]
    size = np.abs(rng.randn(b, h, w, 2)).astype(np.float32) * 6.0
    offset = rng.uniform(-1.5, 2.5, (b, h, w, 2)).astype(np.float32)
    return center, size, offset


@pytest.mark.parametrize("seed,density,top_k,box_nms_iou", [
    (1, 0.1, 48, 0.7), (2, 0.1, 48, None), (3, 0.2, 100, 0.3),
    (4, 0.04, 22, 0.7)])
def test_decode_detections_matches_jax(seed, density, top_k, box_nms_iou):
    maps = seeded_maps(seed, density)
    want = jdet.decode_detections(
        jdet.DetectorOutput(*(jnp.asarray(m) for m in maps)), top_k=top_k,
        box_nms_iou=box_nms_iou)
    out = tdet.DetectorOutput(*(torch.from_numpy(m) for m in maps))
    got = tdet.decode_detections(out, top_k=top_k, box_nms_iou=box_nms_iou)
    ws, wb = np.asarray(want.scores), np.asarray(want.boxes)
    np.testing.assert_array_equal(got.scores.numpy(), ws)
    np.testing.assert_allclose(got.boxes.numpy(), wb, rtol=0, atol=BOX_TOL)
    # Ties and zero-score tails are there, and the suppressed boxes too.
    positive = ws[ws > 0]
    assert len(positive) > len(np.unique(positive))
    assert (ws == 0).sum(1).min() > 0
    # torch.topk orders the equal scores otherwise: its boxes differ.
    heat = torch.sigmoid(out.center_logits[..., 0])
    pooled = torch.nn.functional.max_pool2d(heat[:, None], 3, 1, 1)[:, 0]
    peaks = torch.where(heat >= pooled, heat, 0.0).reshape(B, -1)
    _, idx = torch.topk(peaks, top_k, dim=1)
    _, stable = torch.sort(peaks, dim=1, descending=True, stable=True)
    assert not torch.equal(idx, stable[:, :top_k])


def test_decode_detections_keeps_slot_zero_among_invalid_slots():
    """The box NMS leaves invalid slots (index 0, valid False) once every
    box is kept or suppressed; they must not clear slot 0's score."""
    center = np.full((1, 4, 4, 1), -8.0, np.float32)
    center[0, 0, 0] = center[0, 0, 2] = center[0, 2, 0] = 3.0
    size = np.full((1, 4, 4, 2), 40.0, np.float32)      # all overlap
    offset = np.zeros((1, 4, 4, 2), np.float32)
    maps = (center, size, offset)
    want = jdet.decode_detections(
        jdet.DetectorOutput(*(jnp.asarray(m) for m in maps)), top_k=16)
    got = tdet.decode_detections(
        tdet.DetectorOutput(*(torch.from_numpy(m) for m in maps)), top_k=16)
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))
    assert float(got.scores[0, 0]) > 0.9 and (got.scores[0, 1:] == 0).all()


@pytest.fixture(scope="module")
def frames_u8():
    """Two 256×448 synthetic frames of 8 players (the evaluation's shape),
    rendered through K3's PyTorch mirror, as uint8."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    try:
        data = tsynth.synth_frame_batch(
            synthesize_assets(), torch.Generator().manual_seed(7), b=2,
            n_players=8, hw=(256, 448))
    finally:
        mp.undo()
    return (data["image"].numpy() * 255.0).astype(np.uint8)


@pytest.mark.parametrize("flip_tta", [False, True])
def test_player_detector_runner_matches_jax(port_det, jax_variables,
                                            frames_u8, flip_tta):
    runner = textract.PlayerDetectorRunner(port_det, (256, 448),
                                           flip_tta=flip_tta, device="cpu")
    jrunner = jextract.PlayerDetectorRunner(jdet.PlayerDetector(),
                                            jax_variables, (256, 448),
                                            flip_tta=flip_tta)
    got = runner(frames_u8)
    want = jrunner(frames_u8)
    dets = runner.forward(frames_u8)
    scores = dets.scores.numpy()
    flips = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == 4
        # Match each JAX box to the port's nearest one.
        d = (np.abs(g[:, None] - w[None]).max(-1) if len(g) and len(w)
             else np.zeros((len(g), len(w))))
        matched = (d <= RUNNER_BOX_TOL)
        unmatched = int((~matched.any(0)).sum() + (~matched.any(1)).sum())
        near = np.abs(scores[i] - 0.7) < NEAR_THRESH
        assert unmatched <= int(near.sum()), (i, d.min(initial=0))
        flips += unmatched
        assert len(w) > 0
    print("boxes kept by one package only: %d" % flips)
