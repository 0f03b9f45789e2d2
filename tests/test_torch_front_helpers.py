"""The port's front-end host helpers against the JAX package's, element for
element, on seeded numpy inputs: ``pipeline/preprocess.py`` (bbox
conversions, the centre pick, pad-to-square, the green-padded square crop,
the jittered seg/joints crop, motion blur), ``pipeline/detection.py`` (the
centre and largest-centred picks, the per-view and broadcast crops, the
torchvision interop's ImportError), ``pipeline/field.py``
(``FieldDetector.detect`` on a synthetic pitch frame, the hue and its
helpers) and ``pipeline/densepose.py`` (IUV decode from bytes and base64,
the paste, the silhouette)."""

import base64

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.pipeline import densepose as jdp  # noqa: E402
from soccerplayershapepose_tpu.pipeline import detection as jdet  # noqa: E402
from soccerplayershapepose_tpu.pipeline import field as jfield  # noqa: E402
from soccerplayershapepose_tpu.pipeline import preprocess as jpre  # noqa

from soccerplayershapepose_torch.pipeline import densepose as tdp  # noqa
from soccerplayershapepose_torch.pipeline import detection as tdet  # noqa
from soccerplayershapepose_torch.pipeline import field as tfield  # noqa
from soccerplayershapepose_torch.pipeline import preprocess as tpre  # noqa

SEEDS = (0, 1, 2)
# The JAX package's convex hull calls np.cross on 2-D vectors, which numpy
# 2 deprecates (one warning per hull step).
pytestmark = pytest.mark.filterwarnings(
    "ignore:Arrays of 2-dimensional vectors:DeprecationWarning")


def same(a, b):
    """Equal element for element, with the same dtype and shape (or both
    None, or equal scalars)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def boxes(rng, n, hw=(120, 200)):
    """n corner boxes inside (and a little past the edges of) a frame."""
    h, w = hw
    x1 = rng.uniform(-10, w - 20, n)
    y1 = rng.uniform(-10, h - 30, n)
    return np.stack([x1, y1, x1 + rng.uniform(8, 60, n),
                     y1 + rng.uniform(15, 90, n)], -1)


@pytest.mark.parametrize("seed", SEEDS)
def test_bbox_conversions_and_centre_pick(seed):
    rng = np.random.RandomState(seed)
    b = boxes(rng, 7)
    same(tpre.corners_to_centre_size(b), jpre.corners_to_centre_size(b))
    cs = jpre.corners_to_centre_size(b)
    same(tpre.centre_size_to_corners(cs), jpre.centre_size_to_corners(cs))
    for hw in ((120, 200), (64, 64), (480, 270)):
        assert tpre.get_centre_object(b, hw) == jpre.get_centre_object(b, hw)


@pytest.mark.parametrize("seed", SEEDS)
def test_pad_to_square(seed):
    rng = np.random.RandomState(seed)
    for shape in ((13, 21, 3), (30, 8), (9, 9, 2)):
        img = rng.randint(0, 255, shape).astype(np.uint8)
        same(tpre.pad_to_square(img), jpre.pad_to_square(img))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("border,out_size", [(40, 512), (15, 64), (0, 96)])
def test_square_crop_padded(seed, border, out_size):
    rng = np.random.RandomState(seed)
    frame = rng.randint(0, 255, (120, 200, 3)).astype(np.uint8)
    gray = frame[..., 0].copy()
    for box in boxes(rng, 4):
        for img in (frame, gray):
            same(tpre.square_crop_padded(img, box, border, out_size),
                 jpre.square_crop_padded(img, box, border, out_size))


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_crop_seg_to_bbox(seed):
    rng = np.random.RandomState(seed)
    seg = np.zeros((3, 48, 40), np.uint8)
    seg[0, 10:30, 12:20] = 1
    seg[1, 2:47, 30:39] = 1          # at the frame's edge
    j2d = rng.uniform(0, 40, (3, 17, 2)).astype(np.float32)
    got = tpre.batch_crop_seg_to_bbox(seg, j2d,
                                      rng=np.random.RandomState(seed))
    want = jpre.batch_crop_seg_to_bbox(seg, j2d,
                                       rng=np.random.RandomState(seed))
    same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k,horizontal", [(1, True), (5, True), (4, False)])
def test_add_motion_blur(seed, k, horizontal):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (17, 23, 3)).astype(np.uint8)
    same(tpre.add_motion_blur(img, k, horizontal),
         jpre.add_motion_blur(img, k, horizontal))


@pytest.mark.parametrize("seed", SEEDS)
def test_detection_helpers(seed):
    rng = np.random.RandomState(seed)
    frame = rng.randint(0, 255, (120, 200, 3)).astype(np.uint8)
    for n in (0, 1, 5):
        b = boxes(rng, n)
        same(tdet.select_centre_player(b, frame.shape[:2]),
             jdet.select_centre_player(b, frame.shape[:2]))
        for tol in (0.25, 0.05):
            assert (tdet.largest_centred_box(b, frame.shape[:2], tol)
                    == jdet.largest_centred_box(b, frame.shape[:2], tol))
        same(tdet.crop_player_view(frame, b), jdet.crop_player_view(frame, b))
        same(tdet.crop_player_view(frame, b, border=3),
             jdet.crop_player_view(frame, b, border=3))
        same(tdet.crop_broadcast_players(frame, b),
             jdet.crop_broadcast_players(frame, b))


def test_torch_person_detector_needs_torchvision():
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            tdet.TorchPersonDetector()
        with pytest.raises(ImportError, match="torchvision"):
            tdet.TorchPersonDetector(device="cpu")
    else:
        pytest.skip("torchvision is installed: the ImportError path is moot")


def pitch_frame(seed, hw=(72, 128)):
    """A broadcast-like frame: stands and sky above a grass band of two
    mowing shades, players (kit colours) and white lines on the grass."""
    rng = np.random.RandomState(seed)
    h, w = hw
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rng.randint(60, 200, (1, 1, 3))
    top = h // 4 + rng.randint(-4, 5)
    img[:top] = rng.randint(0, 255, (top, w, 3))          # stands
    for i, x0 in enumerate(range(0, w, 16)):
        shade = (40, 140, 50) if i % 2 else (55, 160, 60)
        img[top:, x0:x0 + 16] = shade
    img[top:] = np.clip(img[top:].astype(int)
                        + rng.randint(-6, 7, img[top:].shape), 0, 255)
    img[top + 10, :] = 235                                  # a line
    for _ in range(5):                                      # players
        y, x = rng.randint(top + 4, h - 12), rng.randint(0, w - 5)
        img[y:y + 10, x:x + 4] = rng.randint(0, 255, 3)
    return img


@pytest.mark.parametrize("seed", SEEDS)
def test_field_detector(seed):
    img = pitch_frame(seed)
    same(tfield.rgb_to_hue(img), jfield.rgb_to_hue(img))
    got = tfield.FieldDetector().detect(img)
    same(got, jfield.FieldDetector().detect(img))
    assert got.sum() > 0.4 * got.size       # the grass is found
    small = dict(tight_band=3, loose_band=9, open_size=3, dilate_size=5,
                 close_size=7)
    same(tfield.FieldDetector(**small).detect(img),
         jfield.FieldDetector(**small).detect(img))


@pytest.mark.parametrize("seed", SEEDS)
def test_field_components_and_hull(seed):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(40, 50) > 0.7).astype(np.uint8)
    same(tfield.largest_connected_component(mask),
         jfield.largest_connected_component(mask))
    same(tfield.largest_connected_component(np.zeros_like(mask)),
         jfield.largest_connected_component(np.zeros_like(mask)))
    lcc = jfield.largest_connected_component(mask)
    same(tfield.convex_hull_fill(lcc), jfield.convex_hull_fill(lcc))


@pytest.mark.parametrize("seed", SEEDS)
def test_densepose_iuv(seed):
    rng = np.random.RandomState(seed)
    iuv = rng.randint(0, 255, (21, 17, 3)).astype(np.uint8)
    iuv[rng.rand(21, 17) > 0.6, 0] = 0
    raw = jdp.encode_png(iuv)
    for data in (raw, base64.b64encode(raw).decode()):
        same(tdp.decode_iuv_result((3, 21, 17), data),
             jdp.decode_iuv_result((3, 21, 17), data))
    gray = jdp.encode_png(iuv[..., 0])
    same(tdp.decode_iuv_result((3, 21, 17), gray),
         jdp.decode_iuv_result((3, 21, 17), gray))
    with pytest.raises(ValueError):
        tdp.decode_iuv_result((3, 20, 17), raw)
    for box in ([3.4, 5.6, 20, 30], [50.2, 40.7, 70, 70], [0, 0, 17, 21]):
        canvas = tdp.paste_iuv_into_frame((60, 64), iuv, np.array(box))
        same(canvas, jdp.paste_iuv_into_frame((60, 64), iuv, np.array(box)))
        same(tdp.iuv_to_silhouette(canvas), jdp.iuv_to_silhouette(canvas))
