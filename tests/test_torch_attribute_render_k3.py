"""The attribute renders (``render/attribute.py``: ``render_part_segmentation``,
``render_textured``) through the z-buffer kernel K3 on a CUDA card, against
the dense plain route on the same CUDA tensors, at 128² on one SMPL body.

This file imports no JAX, so the card's test command (which runs without
JAX) can collect it; ``test_torch_attribute_render.py`` takes its scenes and
its tie arithmetic from here. The bar is the one ``chip_smoke.py``'s
``attr_render`` holds at 512²:

* the masks are equal;
* off the depth ties (the routes on faces whose depths lie within
  ``K3_TIE_ULPS``) the routes take the same face: every attribute within
  ``K3_ATTR_TOL``, K3's gap to the plain version on one face;
* a part label may differ only at a near-tie: the top two one-hot weights
  within ``TIE_W`` on either route, or a depth tie; such pixels are
  counted, printed and at most ``TIE_FRAC`` of the covered ones;
* the textured image agrees within ``IMG_TOL`` off the depth ties, except
  where the UV gap, times the map's steepest texel step and its size,
  bounds a larger gap (a bilinear map turns a UV gap of ~1e-5 on a random
  texture into ~1e-3); those pixels are counted and printed.

Skipped without a card (marker ``cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch.ops import segmentation as tseg  # noqa: E402
from soccerplayershapepose_torch.render import attribute as tattr  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.texture import uv as tuv  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

NUM_PARTS = 7              # the 6-part LSP labels and the background
TIE_W = 1e-5               # top-two one-hot weights this close: a near-tie
K3_TIE_ULPS = 8            # depths this close: either face may win
K3_ATTR_TOL = 1e-5         # K3 against its plain version on one face
TIE_FRAC = 1e-2
IMG_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def body_scene(wh):
    """One synthetic SMPL body's template, facing the camera, its parts in
    the 6-part LSP label space (DensePose id = dominant joint + 1)."""
    a = synthesize_assets()
    v = a.v_template.numpy()
    v2d = np.stack([v[:, 0] * wh * 0.9 + wh / 2,
                    -v[:, 1] * wh * 0.45 + wh / 2], -1)[None]
    z = (v[:, 2] + 5.0)[None]
    parts = tseg.densepose_to_6part_lsp(tsynth.vertex_parts(a) + 1).numpy()
    return (v2d.astype(np.float32), z.astype(np.float32),
            a.faces.numpy().astype(np.int32), parts,
            tsynth.vertex_uv(a).numpy())


def texture_map(seed=1):
    """A 96² normal map of a random atlas: neighbouring texels differ by up
    to ~1, the steepest case for the image's bar."""
    atlas = np.random.RandomState(seed).rand(24, 16, 16, 3).astype(
        np.float32)
    return tuv.atlas_to_normal(_t(atlas), normal_res=96)


def scene_attrs(scene, num_parts=NUM_PARTS):
    """(B, V, num_parts + 3) per-vertex attributes of a scene: the one-hot
    part, the UV and the depth."""
    v2d, z, _, parts, uv = scene
    b = v2d.shape[0]
    per_vertex = np.concatenate(
        [np.eye(num_parts, dtype=np.float32)[parts], uv], -1)
    return np.concatenate([np.broadcast_to(per_vertex,
                                           (b,) + per_vertex.shape),
                           z[..., None]], -1)


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def route_ties(a, b, covered, face_tol, num_parts=NUM_PARTS):
    """Where two routes' interpolated ``scene_attrs`` ``a`` and ``b``
    (B, H, W, num_parts + 3) may rightly differ, over the ``covered``
    pixels: (label ties, depth ties, the UV gap per pixel). A label tie is
    a near-tie of the top two one-hot weights on either route, or a depth
    tie: the attributes apart by more than ``face_tol`` (another face) at
    depths within ``K3_TIE_ULPS``."""
    weight_tie = np.zeros(a.shape[:-1], bool)
    for x in (a, b):
        top2 = np.sort(x[..., :num_parts], -1)[..., -2:]
        weight_tie |= (top2[..., 1] - top2[..., 0]) <= TIE_W
    za, zb = a[..., -1], b[..., -1]
    other_face = np.abs(a[..., :-1] - b[..., :-1]).max(-1) > face_tol
    depth_tie = other_face & (np.abs(za - zb) <= K3_TIE_ULPS * _ulp(
        np.maximum(np.abs(za), np.abs(zb))))
    uv_gap = np.abs(a[..., num_parts:-1] - b[..., num_parts:-1]).max(-1)
    return ((weight_tie | depth_tie) & covered, depth_tie & covered, uv_gap)


def steepest_texel_step(tex: np.ndarray) -> float:
    """The largest gap between neighbouring texels of an (H, W, C) map."""
    return float(max(np.abs(np.diff(tex, axis=0)).max(),
                     np.abs(np.diff(tex, axis=1)).max()))


def image_slope(tex: np.ndarray) -> float:
    """|Δimage| ≤ (W − 1 + H − 1) · steepest step · |Δuv| for a bilinear
    map."""
    return (tex.shape[0] + tex.shape[1] - 2) * steepest_texel_step(tex)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_renders_through_k3_match_the_plain_route(cuda_device):
    """Both renders on the card (K3) against the plain route on the same
    CUDA tensors at 128²: masks equal, the same face off the depth ties,
    labels equal off the near-ties, the image within ``IMG_TOL`` or its UV
    gap's bound there."""
    wh = 128
    scene = body_scene(wh)
    v2d, z, faces, parts, uv = (_t(x).to(cuda_device) for x in scene)
    attrs = _t(scene_attrs(scene)).to(cuda_device)
    a_k, m_k = tattr.rasterize_attributes(v2d, z, attrs, faces, wh)
    a_p, m_p = tattr.rasterize_attributes_plain(v2d, z, attrs, faces, wh)
    assert torch.equal(m_k, m_p)
    ak, ap, covered = a_k.cpu().numpy(), a_p.cpu().numpy(), m_p.cpu().numpy()
    ties, depth_ties, uv_gap = route_ties(ak, ap, covered, K3_ATTR_TOL)
    off = covered & ~depth_ties
    assert (np.abs(ak - ap)[..., :-1].max(-1)[off] <= K3_ATTR_TOL).all()

    labels = tattr.render_part_segmentation(v2d, z, parts, faces, wh)
    plain = torch.where(m_p, torch.argmax(a_p[..., :NUM_PARTS], -1), 0)
    apart = (labels != plain).cpu().numpy()
    print("%d of %d covered pixels apart, %d depth ties"
          % (int(apart.sum()), int(covered.sum()), int(depth_ties.sum())))
    assert (~apart | ties).all()
    assert apart.sum() <= TIE_FRAC * covered.sum()

    tex = texture_map().to(cuda_device)
    img, mask = tattr.render_textured(v2d, z, uv, faces, tex, wh)
    assert torch.equal(mask, m_p)
    ref = tuv.sample_uv_texture(
        tex, a_p[..., NUM_PARTS:NUM_PARTS + 2].reshape(-1, 2)
    ).reshape(img.shape) * m_p[..., None]
    gap = (img - ref).abs().amax(-1).cpu().numpy()
    slope = image_slope(tex.cpu().numpy())
    steep = off & (gap > IMG_TOL)
    print("image gap %.3g off the depth ties; %d pixels above %g, each "
          "within its UV gap (max %.3g) x %.4g"
          % (gap[off].max(), int(steep.sum()), IMG_TOL,
             uv_gap[off].max(), slope))
    assert (gap[steep] <= IMG_TOL + slope * uv_gap[steep]).all()
    assert (img.cpu().numpy()[~covered] == 0).all()
    assert float(img.max()) > 0.5
