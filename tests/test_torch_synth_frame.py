"""The port's synthetic frames (``train/synth.py:render_frame_batch``)
against the JAX package's ``synth_frame_batch``, on the draws of the JAX
key stream, at 64×96 with 3 players per frame.

:func:`jax_frame_draws` replays the key splits of ``synth_frame_batch``:
the bodies from ``keys[0]``, each player's camera from the three splits
of ``keys[1]``, the validity from ``keys[2]``, the shading from
``keys[3]``, the kit from ``keys[4]``, the pitch from ``keys[5]``, the
blur from ``keys[6]`` and the photometric jitter from ``fold_in(keys[7],
1)``.

The port renders through K3's PyTorch mirror
(``test_torch_extract.fast_rasterize_attributes``: the kernel route's
sort, face records, pruned (z, id) key minimum and gather): the dense
plain pass over three bodies takes ~30 s per batch here. JAX renders with
its dense oracle.

Tolerances (B = 2):

* from the same draws: boxes, mask and visible fill ≤ 1e-5 max abs (the
  boxes are the extremes of the projected vertices, which the two SMPL
  forwards place within ~1e-5 px; a visible pixel that moves would shift
  a fill by > 5e-4, and none does). The two rendered scenes (colours and
  player ids, the depth riding along as a last channel): a pixel covered
  on one side only, or whose colour or id differs by more than 1e-5, must
  be an edge pixel (its centre within ``EDGE_PX`` of an edge of one of
  JAX's projected faces) or a depth tie (the depths chosen within
  ``K3_TIE_ULPS``), and such pixels are counted, printed and at most 1% of
  the covered pixels. Every image pixel apart by more than 1e-5 lies
  within the motion blur's reach (``BLUR_KSIZE // 2`` px) of one of them:
  the composition is held on its own below;
* on JAX's own scene (its vertices, depths, colours and ids, captured
  inside ``synth_frame_batch``): mask exact; colours and ids ≤ 1e-5 except
  at depth ties, pixels where the two take faces whose depths lie within
  ``K3_TIE_ULPS`` (the depth rides along as a last channel), counted,
  printed and at most 1% of the covered pixels;
* the image composed from JAX's rendered bodies: ≤ 1e-5 max abs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import zbuffer as zb  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import fast_rasterize_attributes  # noqa: E402
from test_torch_synth_eval import jax_body_draws  # noqa: E402
from test_torch_synth_rgb import (  # noqa: E402
    K3_TIE_ULPS, jax_background_draws, jax_blur_draws, jax_kit_draws,
    jax_photometric_draws, jax_shading_draws)

B, N, HW = 2, 3, (64, 96)
TOL = 1e-5
PX_FRAC = 1e-2
# A pixel centre this close to a projected face edge may fall on either
# side of it: the two SMPL forwards place the vertices within ~1e-5 px,
# and an fp32 edge function at these coordinates rounds far below this.
EDGE_PX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_frame_draws(rng, b, n_players, hw):
    """The draws of ``jsynth.synth_frame_batch(rng, b, n_players, hw)``."""
    h, w = hw
    bn = b * n_players
    keys = jax.random.split(rng, 8)
    ks = jax.random.split(keys[1], 3)
    u = jax.random.uniform
    cam = jnp.stack([u(ks[0], (bn,), minval=0.08, maxval=0.28),
                     u(ks[1], (bn,), minval=-0.85, maxval=0.85),
                     u(ks[2], (bn,), minval=-0.75, maxval=0.75)], axis=-1)
    valid = jax.random.bernoulli(keys[2], 0.8, (bn,)).astype(jnp.float32)
    return tsynth.FrameDraws(
        body=jax_body_draws(keys[0], bn), cam_wp=_t(cam),
        valid=_t(valid).reshape(b, n_players),
        appearance=tsynth.AppearanceDraws(
            kit=jax_kit_draws(keys[4], bn),
            shading=jax_shading_draws(keys[3], bn),
            occluder_kit=None, occluder_shading=None,
            background=jax_background_draws(keys[5], b, h, w),
            blur=jax_blur_draws(keys[6], b),
            photometric=jax_photometric_draws(jax.random.fold_in(keys[7], 1),
                                              b, h, w)))


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's frames and the scene its rasterizer saw, with the depth as a
    last attribute channel so that the depth it chose at each pixel is
    read (the other channels are those of ``synth_frame_batch``)."""
    seen = {}
    inner = jsynth.rasterize_attributes

    def recording(v2d, z, attrs, faces, img_wh):
        az = jnp.concatenate([attrs, z[..., None]], axis=-1)
        out, mask = inner(v2d, z, az, faces, img_wh)
        jax.debug.callback(lambda *a: seen.setdefault(
            "scene", [np.asarray(x) for x in a]), v2d, z, attrs, faces, out,
            mask)
        return out[..., :-1], mask

    mp = pytest.MonkeyPatch()
    mp.setattr(jsynth, "rasterize_attributes", recording)
    try:
        key = jax.random.PRNGKey(11)
        batch = jsynth.synth_frame_batch.__wrapped__(
            jassets.synthesize_assets(), key, b=B, n_players=N, hw=HW)
        batch = {k: np.asarray(v) for k, v in batch.items()}
    finally:
        mp.undo()
    return key, batch, seen["scene"]


@pytest.fixture(scope="module")
def port_frames(assets, jax_frames):
    """The port's frames from JAX's draws, and its rendered scene with the
    depth as a last attribute channel, as :func:`jax_frames` records
    JAX's."""
    key = jax_frames[0]
    seen = {}

    def recording(v2d, z, attrs, faces, img_wh):
        az = torch.cat([attrs, z[..., None]], dim=-1)
        out, mask = fast_rasterize_attributes(v2d, z, az, faces, img_wh)
        seen["render"] = (out.numpy(), mask.numpy())
        return out[..., :-1], mask

    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", recording)
    try:
        out = tsynth.render_frame_batch(assets,
                                        jax_frame_draws(key, B, N, HW), HW)
    finally:
        mp.undo()
    return {k: v.numpy() for k, v in out.items()}, seen["render"]


def _edge_distance(tri, pix):
    """(P,) distance from each pixel centre ``pix`` (P, 2) [x, y] to the
    nearest edge of the triangles ``tri`` (F, 3, 2)."""
    a, b = tri, np.roll(tri, -1, axis=1)                     # (F, 3, 2)
    ab = (b - a).reshape(1, -1, 2)
    ap = pix[:, None, :] - a.reshape(1, -1, 2)               # (P, 3F, 2)
    t = np.clip((ap * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-12),
                0.0, 1.0)
    return np.linalg.norm(ap - t[..., None] * ab, axis=-1).min(1)


def test_frame_of_jax_draws_matches_jax(jax_frames, port_frames):
    _, want, (v2d, _, _, faces, j_full, j_mask) = jax_frames
    got, (p_full, p_mask) = port_frames
    assert got["image"].shape == (B,) + HW + (3,)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    valid = want["mask"] > 0.5
    assert valid.any() and not valid.all()
    # Dropped players sit +1e5 px away, where one ulp is 8e-3 px.
    np.testing.assert_allclose(got["boxes"][valid], want["boxes"][valid],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got["boxes"][~valid], want["boxes"][~valid],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["visible_fill"], want["visible_fill"],
                               rtol=0, atol=TOL)
    assert (want["visible_fill"][valid] > 0).any()
    # The rendered scenes, pixel by pixel.
    apart = (p_mask != j_mask) | ((p_mask & j_mask) & (np.abs(
        p_full[..., :-1] - j_full[..., :-1]).max(-1) > TOL))
    idx = np.argwhere(apart)                                  # (P, 3) b, y, x
    z_p, z_j = p_full[..., -1][apart], j_full[..., -1][apart]
    tie = (np.abs(z_p - z_j) / _ulp(np.maximum(np.abs(z_p), np.abs(z_j)))
           <= K3_TIE_ULPS) & p_mask[apart] & j_mask[apart]
    edge = np.array([
        _edge_distance(v2d[bi][faces], np.array([[x, y]], np.float32))[0]
        for bi, y, x in idx]).reshape(-1)
    print("rendered pixels apart: %d of %d covered (%d depth ties), edge "
          "distances %s px" % (len(idx), j_mask.sum(), tie.sum(),
                               edge.tolist()))
    assert (tie | (edge <= EDGE_PX)).all()
    assert len(idx) <= PX_FRAC * j_mask.sum()
    # The image: apart only within the blur's reach of those pixels.
    img_apart = np.abs(got["image"] - want["image"]).max(-1) > TOL
    r = tsynth.BLUR_KSIZE // 2
    reach = np.zeros_like(img_apart)
    for bi, y, x in idx:
        reach[bi, max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1] = True
    print("image pixels apart: %d, all within %d px of a rendered pixel "
          "apart" % (img_apart.sum(), r))
    assert not (img_apart & ~reach).any()


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def test_scene_of_jax_renders_as_jax(jax_frames):
    """K3's route on JAX's own scene against JAX's dense oracle: the same
    coverage; colours and player ids apart only at depth ties."""
    _, _, (v2d, z, attrs, faces, j_full, j_mask) = jax_frames
    az = np.concatenate([attrs, z[..., None]], -1)
    full, mask = fast_rasterize_attributes(_t(v2d), _t(z), _t(az), _t(faces),
                                           max(HW))
    full, mask = full.numpy(), mask.numpy()
    np.testing.assert_array_equal(mask, j_mask)
    apart = np.abs(full[..., :-1] - j_full[..., :-1]).max(-1) > TOL
    z_port, z_jax = full[..., -1][apart], j_full[..., -1][apart]
    gap = np.abs(z_port - z_jax) / _ulp(np.maximum(np.abs(z_port),
                                                   np.abs(z_jax)))
    print("depth-tie pixels: %d of %d covered, gaps %s ulps"
          % (apart.sum(), j_mask.sum(), gap.tolist()))
    assert (gap <= K3_TIE_ULPS).all()
    assert apart.sum() <= PX_FRAC * j_mask.sum()
    assert j_mask.sum() > 0


def test_image_composed_from_jax_bodies(jax_frames):
    key, want, (_, _, _, _, j_full, j_mask) = jax_frames
    h, w = HW
    d = jax_frame_draws(key, B, N, HW).appearance
    got = tsynth.compose_image(_t(j_full[:, :h, :w, :3]),
                               _t(j_mask[:, :h, :w].astype(np.float32)), d)
    np.testing.assert_allclose(got.numpy(), want["image"], rtol=0, atol=TOL)


def test_sampled_frames_render_on_cpu(assets):
    """The port's own draws: shapes, the generators' devices, the image in
    [0, 1], dropped players +1e5 px away with no visible pixel, and the
    same frames from the same seeds."""
    gen = torch.Generator().manual_seed(5)
    draws = tsynth.sample_frame_draws(gen, B, 4, HW)
    assert draws.valid.shape == (B, 4) and draws.cam_wp.shape == (B * 4, 3)
    assert draws.appearance.background.noise.shape == (B,) + HW + (3,)
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    try:
        out = tsynth.render_frame_batch(assets, draws, HW)
        again = tsynth.synth_frame_batch(
            assets, torch.Generator().manual_seed(5), b=B, n_players=4,
            hw=HW)
    finally:
        mp.undo()
    for k, v in out.items():
        assert torch.equal(v, again[k]), k
    img = out["image"]
    assert img.shape == (B,) + HW + (3,)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    dropped = out["mask"] < 0.5
    assert (out["boxes"][dropped] > 1e4).all()
    assert (out["visible_fill"][dropped] == 0).all()
    assert (out["visible_fill"] <= 1.0).all()


def test_k3_tables_at_the_pipelines_frame_size(assets):
    """The K3 inputs of one 896² frame of 22 players (303,072 faces, the
    pipeline's synthesis pass): every integer of the host glue fits its
    type, the dropped players' faces fall out of every band's chunk range
    and hold no pixel of their padded boxes, and the (z, id) key keeps the
    largest sorted face id."""
    wh, n = 896, 22
    draws = tsynth.sample_frame_draws(torch.Generator().manual_seed(2), 1, n,
                                      (512, 896))
    draws = draws._replace(valid=(torch.arange(n) % 3 != 0).float()[None])
    seen = tsynth.frame_scene(assets, draws, (512, 896))
    assert seen["wh"] == wh and seen["faces"].shape[0] == n * 13776
    tri9, order, cymin, cymax, _, _, n_chunks = zb._sorted_tri_z_and_ranges(
        seen["verts2d"], seen["verts_z"], seen["faces"])
    assert n_chunks * br.CHUNK >= 303072 and tri9.shape[1] % br.CHUNK == 0
    lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                   br.BAND_H, zb.MARGIN)
    assert lo.dtype == hi.dtype == cymin.dtype == torch.int32
    assert int(hi.max()) <= n_chunks and int(lo.min()) >= 0
    # The dropped players' faces, in sorted order.
    v = assets.v_template.shape[0]
    player = seen["faces"][:, 0].long() // v                  # (F,)
    dropped = (draws.valid[0] < 0.5)[player][order[0]]        # (F,) sorted
    first = int(torch.nonzero(dropped)[0])
    assert dropped[first:].all()          # sorted last, by their +1e5 y
    assert int(hi.max()) <= -(-first // br.CHUNK)
    zr = zb.face_records(tri9)
    assert br.support_pairs(zr[0, first:order.shape[1], zb.BOX], wh) == 0
    assert br.support_pairs(zr[0, :first, zb.BOX], wh) > 0
    big = torch.tensor([n * 13776 - 1])
    key = zb.zkey(torch.tensor([123.5]), big)
    assert int(key & 0xFFFFFFFF) == n * 13776 - 1
