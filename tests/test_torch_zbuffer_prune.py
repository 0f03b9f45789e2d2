"""The per-face pruning and the order-free winner of the z-buffer kernel K3,
on the CPU.

K3 evaluates a (face, pixel) pair only when the pixel centre lies in the
face's float box padded by ``MARGIN`` = 1 px (``face_records``), and keeps
per pixel the least 64-bit (z, sorted id) key. These tests hold the host
glue and the kernel's algorithm, mirrored in PyTorch by
``rasterize_bary_pruned``, to the dense plain version
``rasterize_bary_plain``:

* the face records equal the plain arithmetic they replace; sentinel,
  far-off and NaN faces hold no pixel;
* every pair that passes the plain version's inside test lies in its
  face's padded box: on the evaluation's scene at both pass shapes (512²
  at scale 1 and 128² at scale 0.25; every pixel for the faces whose
  smallest angle is below 1e-3 rad, where the argument of
  ``csrc/zbuffer.cu`` for the pad does not reach, a 4 px ring around the
  box for the others) and on adversarial triangles (vertices a few ulps
  from integer pixel centres, slivers down to 1e-3 px, near-vertical and
  near-horizontal edges, faces off and across the image);
* the mirror is bit-equal to the dense plain version on those cases and on
  a depth tie, a −0.0 / +0.0 tie, faces at ±inf depth and NaN vertices and
  depths;
* ``support_pairs`` and ``box_pairs`` equal a brute-force count;
* a face collinear up to rounding passes the inside test far outside its
  box, where every box-based pruning drops it: the known limit of the pad.

The kernel itself, its pair count and its run-to-run identity are checked
on a CUDA card (marker ``cuda`` below; ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import zbuffer as zb  # noqa: E402

EVAL_SEED = 10_000_000     # the evaluation's seed; sample 0 has its occluder
WINDOW_ORIGIN = 190.0      # the 128² window of the 512² pass's geometry
RING = 4.0                 # px checked around each box beyond the pad
THIN_SIN = 1e-3            # faces below this sin(smallest angle): every pixel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eval_scene():
    """The evaluation's first crop (player and occluder, 27,552 faces) at
    the 512² pass's scale."""
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import synth
    assets = synthesize_assets()
    draws = synth.sample_crop_draws(torch.Generator().manual_seed(EVAL_SEED),
                                    1)
    scene = synth.crop_scene(assets, draws, 512)
    return scene["verts2d"], scene["verts_z"], scene["faces"]


def _table(verts2d, verts_z, faces):
    return zb._sorted_tri_z_and_ranges(verts2d, verts_z, faces)[0]


def _mesh_table(eval_scene, name):
    """(tri9, wh) of a pass of the evaluation's scene: ``mesh512`` the
    512² pass, ``mesh128`` the 128² pass (vertices × 0.25), ``window`` the
    512² pass's geometry seen through a 128² window."""
    v, z, faces = eval_scene
    if name == "mesh512":
        return _table(v, z, faces), 512
    if name == "mesh128":
        return _table(v * 0.25, z, faces), 128
    return _table(v - WINDOW_ORIGIN, z, faces), 128


def _faces_table(tris, depths=None):
    """A sorted table of loose triangles (N, 3, 2), with depths (N, 3)
    (default: a distinct plane per face)."""
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    if depths is None:
        depths = (1.0 + 0.01 * np.arange(n, dtype=np.float32))[:, None] \
            + 0.001 * tris[..., 0]
    v = torch.from_numpy(tris.reshape(1, 3 * n, 2).copy())
    zt = torch.from_numpy(np.asarray(depths, np.float32).reshape(1, 3 * n)
                          .copy())
    faces = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    return _table(v, zt, faces)


# ---------------------------------------------------------------------------
# Adversarial triangles
# ---------------------------------------------------------------------------

ADV_WH = 96


def _lattice_slivers(rng, n, heights):
    """Thin triangles along lines through integer pixel centres: three
    points on the line, the middle one lifted off it by a height drawn
    from ``heights`` (log-uniform) px."""
    p0 = rng.randint(20, 70, (n, 2)).astype(np.float64)
    d = rng.randint(-5, 6, (n, 2)).astype(np.float64)
    d[(d == 0).all(1)] = [1.0, 3.0]
    s = np.sort(rng.uniform(0.0, 3.0, (n, 3)), 1)
    tris = p0[:, None, :] + s[..., None] * d[:, None, :]
    nrm = np.stack([-d[:, 1], d[:, 0]], -1) / np.linalg.norm(d, axis=1,
                                                            keepdims=True)
    h = 10.0 ** rng.uniform(np.log10(heights[0]), np.log10(heights[1]), n)
    tris[:, 1] += nrm * h[:, None]
    return tris


def _adversarial(name):
    rng = np.random.RandomState({"near_integer": 1, "slivers": 2,
                                 "near_vertical": 3, "near_horizontal": 4,
                                 "off_image": 5}[name])
    if name == "near_integer":
        # Vertices at integer pixel centres moved by 0-3 ulps either way:
        # pixel centres on or a rounding away from the edges and vertices.
        base = rng.randint(5, 90, (48, 3, 2)).astype(np.float32)
        steps = rng.randint(-3, 4, base.shape)
        tris = base.copy()
        for k in range(1, 4):
            up = np.nextafter(tris, np.float32(np.inf))
            down = np.nextafter(tris, np.float32(-np.inf))
            tris = np.where(steps >= k, up, np.where(steps <= -k, down, tris))
        return tris
    if name == "slivers":
        return _lattice_slivers(rng, 64, (1e-3, 1e-1))
    if name in ("near_vertical", "near_horizontal"):
        # One edge 5-60 px long and 1e-6-1e-2 px off the axis, through
        # integer pixel centres; the third vertex 0.5-20 px to the side.
        n = 48
        a = rng.randint(10, 80, (n, 2)).astype(np.float64)
        length = rng.uniform(5, 60, n)
        tilt = 10.0 ** rng.uniform(-6, -2, n) * rng.choice([-1, 1], n)
        side = rng.uniform(0.5, 20, n) * rng.choice([-1, 1], n)
        b = a + np.stack([tilt, length], -1)
        c = a + np.stack([side, length * rng.uniform(0, 1, n)], -1)
        tris = np.stack([a, b, c], 1)
        return tris if name == "near_vertical" else tris[..., ::-1].copy()
    # Off the image: far away, across each border, and one face holding
    # the whole image.
    far = np.array([[[1e5, 1e5], [1e5 + 9, 1e5], [1e5, 1e5 + 9]],
                    [[-1e5, 20], [-1e5 + 9, 30], [-1e5, 40]],
                    [[-3.5, -2.25], [10.5, -3.0], [4.0, 8.75]],
                    [[90.5, 40.0], [99.75, 45.5], [93.0, 55.25]],
                    [[30.0, 93.5], [45.0, 97.0], [40.0, 91.0]],
                    [[-50.0, -50.0], [300.0, -40.0], [-40.0, 300.0]]])
    return np.concatenate([far, rng.uniform(-20, 116, (24, 3, 2))], 0)


ADVERSARIAL = ["near_integer", "slivers", "near_vertical", "near_horizontal",
               "off_image"]


def _constructed(name):
    """Small constructed cases for the tie rule and the non-finite
    depths."""
    tri_a = [[4.0, 4.0], [40.0, 6.0], [12.0, 40.0]]
    tri_b = [[8.0, 2.0], [44.0, 30.0], [2.0, 34.0]]
    if name == "depth_tie":
        # Two coplanar faces at one depth, each listed against its y-order,
        # and two copies of one face: the smallest sorted id wins.
        tris = [tri_b, tri_a, tri_a, [[20, 20], [46, 22], [30, 46]]]
        return _faces_table(tris, np.full((4, 3), 5.0))
    if name == "signed_zero":
        # −0.0 on the later face of each pair: taken as +0.0, it ties, and
        # the earlier sorted id wins.
        tris = [tri_a, tri_b, [[50, 50], [90, 52], [60, 90]],
                [[52, 48], [92, 80], [48, 86]]]
        z = np.array([[0.0] * 3, [-0.0] * 3, [-0.0] * 3, [0.0] * 3],
                     np.float32)
        return _faces_table(tris, z)
    if name == "inf_depth":
        # +inf never wins (alone it leaves the pixel empty; on an edge,
        # 0·inf gives a NaN that covers nothing); −inf wins inside.
        tris = [tri_a, tri_b, [[50, 50], [90, 52], [60, 90]],
                [[52, 48], [92, 80], [48, 86]]]
        z = np.array([[np.inf] * 3, [3.0] * 3, [-np.inf] * 3, [2.0] * 3],
                     np.float32)
        return _faces_table(tris, z)
    # A NaN vertex (box NaN, never inside) and a NaN depth (inside, covers
    # nothing), each over a finite face.
    tris = [tri_a, tri_b, [[50, 50], [90, 52], [60, 90]],
            [[52, 48], [92, 80], [48, 86]]]
    tris[0][1] = [np.nan, 6.0]
    z = np.array([[1.0] * 3, [2.0] * 3, [1.0, np.nan, 1.0], [2.0] * 3],
                 np.float32)
    return _faces_table(tris, z)


CONSTRUCTED = ["depth_tie", "signed_zero", "inf_depth", "nan"]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _inside_pairs(tri9, face, px, py):
    """The plain inside test at the given pairs (face indices into the
    flattened table)."""
    inside, *_ = zb._pair_bary(zb.face_records(tri9).reshape(-1, zb.REC)[face],
                               px.float(), py.float())
    return inside


def _in_box(boxes, px, py):
    x0, x1, y0, y1 = boxes.unbind(-1)
    return (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)


def _covers(tri9, wh):
    """(F_pad, wh, wh) bool: the plain inside test of every face of a small
    table (B = 1) at every pixel."""
    zr = zb.face_records(tri9)[0]
    f = zr.shape[0]
    pix = torch.arange(wh * wh)
    inside, *_ = zb._pair_bary(zr.repeat_interleave(wh * wh, 0),
                               (pix % wh).float().repeat(f),
                               (pix // wh).float().repeat(f))
    return inside.reshape(f, wh, wh)


def _sin_smallest_angle(tri9):
    """sin of each face's smallest angle, in float64: twice the area over
    the two longer edges."""
    t = tri9[..., :6].double()
    ax, ay, bx, by, cx, cy = t.unbind(-1)
    a2 = ((bx - ax) * (cy - ay) - (by - ay) * (cx - ax)).abs()
    lens = torch.sort(torch.stack([torch.hypot(bx - ax, by - ay),
                                   torch.hypot(cx - bx, cy - by),
                                   torch.hypot(ax - cx, ay - cy)], -1),
                      -1).values
    return a2 / (lens[..., 2] * lens[..., 1]).clamp(min=1e-300)


def _outside_inside_pairs(tri9, wh, ring=None):
    """(pairs checked, pairs that pass the inside test outside their face's
    padded box). With ``ring`` the pairs of each box padded by MARGIN +
    ``ring``; without, every pixel of every face. Face by face in steps,
    to keep the per-pair tensors small."""
    zr = zb.face_records(tri9).reshape(-1, zb.REC)
    n = zr.shape[0]
    step = 4 if ring is None else 1024
    checked = outside = 0
    for s in range(0, n, step):
        k = min(step, n - s)
        if ring is None:
            face = torch.arange(s, s + k).repeat_interleave(wh * wh)
            pix = torch.arange(wh * wh).repeat(k)
            px, py = pix % wh, pix // wh
        else:
            face, px, py = zb.box_pairs(
                br.face_boxes(zr[s:s + k, :6], zb.MARGIN + ring), wh)
            face = face + s
        inside, *_ = zb._pair_bary(zr[face], px.float(), py.float())
        out = inside & ~_in_box(zr[face, zb.BOX], px.float(), py.float())
        checked += face.numel()
        outside += int(out.sum())
    return checked, outside


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_face_records_equal_plain_arithmetic():
    """Vertices and depths copied, each edge vector the plain version's
    per-pair xb − xa, the box the float box padded by MARGIN; sentinel
    (padding), far-off and NaN faces hold no pixel."""
    tris = [[[4.0, 4.0], [40.0, 6.0], [12.0, 40.0]],
            [[1e5, 1e5], [1e5 + 9, 1e5], [1e5, 1e5 + 9]],
            [[np.nan, 5.0], [20.0, 30.0], [9.0, 12.0]],
            [[30.25, 2.5], [31.0, 20.0], [29.5, 9.125]]]
    tri9 = _faces_table(tris)
    assert tri9.shape[1] == br.CHUNK          # four sentinels pad the chunk
    zr = zb.face_records(tri9)
    assert zr.shape == (1, br.CHUNK, zb.REC) and zr.dtype == torch.float32
    ax, ay, bx, by, cx, cy = tri9[..., :6].unbind(-1)
    edges = torch.stack([cx - bx, cy - by, ax - cx, ay - cy, bx - ax,
                         by - ay], -1)
    for got, want in ((zr[..., :9], tri9), (zr[..., 9:15], edges),
                      (zr[..., 15], torch.zeros_like(ax)),
                      (zr[..., zb.BOX], br.face_boxes(tri9[..., :6], 1.0))):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    boxes = zr[..., zb.BOX]
    per_face = [br.support_pairs(boxes[:, i], 64) for i in range(br.CHUNK)]
    live = tri9[0, :, 0] > -1e8
    sentinel = tri9[0, :, 0] < -1e8
    far = tri9[0, :, 0] > 1e4
    nan = torch.isnan(tri9[0, :, :6]).any(-1)
    assert sentinel.sum() == 4 and far.sum() == 1 and nan.sum() == 1
    for i in range(br.CHUNK):
        if sentinel[i] or far[i] or nan[i]:
            assert per_face[i] == 0
        else:
            assert live[i] and per_face[i] > 0


@pytest.mark.parametrize("name", ["mesh512", "mesh128"])
def test_pruning_drops_no_inside_pair_on_the_evaluation(eval_scene, name):
    tri9, wh = _mesh_table(eval_scene, name)
    live = (tri9[0, :, 0] > -1e8) & (tri9[0, :, 0] < 1e4)
    thin = live & (_sin_smallest_angle(tri9[0]) < THIN_SIN)
    n_ring, out_ring = _outside_inside_pairs(tri9[:, live & ~thin], wh, RING)
    n_full, out_full = _outside_inside_pairs(tri9[:, thin], wh)
    assert out_ring == 0 and out_full == 0
    # Not vacuous: both checks ran over many pairs and faces.
    assert int(thin.sum()) >= 10 and n_full >= 10 * wh * wh
    assert n_ring > br.support_pairs(zb.face_records(tri9)[..., zb.BOX], wh)


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_pruning_drops_no_inside_pair_on_adversarial_faces(name):
    tri9 = _faces_table(_adversarial(name))
    n, out = _outside_inside_pairs(tri9, ADV_WH)
    assert out == 0
    zr = zb.face_records(tri9)
    fid, _, _ = zb.rasterize_bary_plain(tri9, ADV_WH)
    assert (fid >= 0).sum() > 20          # the faces cover pixels


@pytest.mark.parametrize("name", ["mesh128", "window"] + ADVERSARIAL
                         + CONSTRUCTED)
def test_pruned_mirror_equals_plain(eval_scene, name):
    """The kernel's algorithm (pruned pairs, (z, id) key minimum, resolve)
    gives the dense plain version's ids and barycentrics bit for bit."""
    if name in ("mesh128", "window"):
        tri9, wh = _mesh_table(eval_scene, name)
    elif name in ADVERSARIAL:
        tri9, wh = _faces_table(_adversarial(name)), ADV_WH
    else:
        tri9, wh = _constructed(name), ADV_WH
    want = zb.rasterize_bary_plain(tri9, wh)
    got = zb.rasterize_bary_pruned(zb.face_records(tri9), wh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    fid = want[0]
    assert (fid >= 0).any()
    if name in CONSTRUCTED:
        covers = _covers(tri9, wh)                           # (F, wh, wh)
        ids = torch.arange(covers.shape[0])[:, None, None]
        z = tri9[0, :, 6:9]
        if name == "depth_tie":
            # Faces 1 and 2 are copies (sorted after face 0, whose y is
            # least): at every pixel their z ties and face 1 wins.
            assert torch.equal(tri9[0, 1], tri9[0, 2])
            assert (fid == 1).any() and not (fid == 2).any()
        elif name == "signed_zero":
            # Every depth is ±0.0, −0.0 taken as +0.0: each pixel goes to
            # the smallest sorted id that covers it.
            first = torch.where(covers, ids, covers.shape[0]).amin(0)
            assert torch.equal(fid[0], torch.where(
                first < covers.shape[0], first, -1).to(torch.int32))
            assert (covers.sum(0) > 1).any()
        else:
            # +inf and NaN never win; −inf wins wherever it covers.
            never = torch.isinf(z).all(-1) & (z > 0).all(-1) \
                | torch.isnan(tri9[0]).any(-1)
            assert never.any() and not never[fid[fid >= 0].long()].any()
            for i in torch.nonzero((z == -np.inf).all(-1))[:, 0].tolist():
                assert (fid[0][covers[i]] == i).float().mean() > 0.9


@pytest.mark.parametrize("name", ["mesh128", "off_image", "nan"])
def test_support_pairs_equal_brute_force(eval_scene, name):
    if name == "mesh128":
        tri9, wh = _mesh_table(eval_scene, name)
    elif name == "off_image":
        tri9, wh = _faces_table(_adversarial(name)), ADV_WH
    else:
        tri9, wh = _constructed(name), ADV_WH
    boxes = zb.face_records(tri9)[..., zb.BOX].reshape(-1, 4)
    coords = torch.arange(wh, dtype=torch.float32)
    x0, x1, y0, y1 = (boxes[:, i, None] for i in range(4))
    inx = (coords >= x0) & (coords <= x1)                    # (N, wh)
    iny = (coords >= y0) & (coords <= y1)
    brute = int((inx.sum(-1) * iny.sum(-1)).sum())
    assert br.support_pairs(boxes, wh) == brute > 0
    face, px, py = zb.box_pairs(boxes, wh)
    assert face.numel() == brute
    assert bool((inx[face, px] & iny[face, py]).all())
    # each pair once
    key = (face * wh + py) * wh + px
    assert torch.unique(key).numel() == brute


def test_face_collinear_up_to_rounding_leaks_past_every_box():
    """The limit of the pad: a face whose middle vertex lies 1e-6 px off
    the line through the other two (collinear up to the rounding of its
    edge functions) passes the rounded inside test at pixel centres on
    that line 200 px and more outside its box. Every box-based pruning
    drops them (K3's pad, the chunk tiles of the Pallas kernel and of K3's
    first port); the dense plain version keeps them. The mirror agrees
    with the plain version everywhere else."""
    sliver = [[103.79385375976562, 273.3918151855469],
              [106.39196014404297, 276.85595703125],
              [109.04193115234375, 280.3892517089844]]
    wh = 512
    tri9 = _faces_table([sliver, [[20.0, 20.0], [60.0, 24.0], [30.0, 70.0]]])
    flat = tri9.reshape(-1, 9)
    face = torch.zeros(wh * wh, dtype=torch.long)
    pix = torch.arange(wh * wh)
    px, py = pix % wh, pix // wh
    row = int(torch.nonzero(flat[:, 0] > 100)[0, 0])
    inside = _inside_pairs(tri9, face + row, px, py)
    box = br.face_boxes(flat[row, :6], zb.MARGIN)
    leak = inside & ~_in_box(box, px.float(), py.float())
    dist = torch.maximum(torch.maximum(box[0] - px, px - box[1]),
                         torch.maximum(box[2] - py, py - box[3]))
    assert int(leak.sum()) >= 1 and float(dist[leak].max()) > 200
    want = zb.rasterize_bary_plain(tri9, wh)
    got = zb.rasterize_bary_pruned(zb.face_records(tri9), wh)
    apart = (got[0] != want[0]).reshape(-1)
    assert torch.equal(apart, leak)
    assert (want[0].reshape(-1)[leak] == row).all()
    assert (got[0].reshape(-1)[leak] == -1).all()


def _glue_of(tri9):
    """The kernel's inputs for a sorted table's faces, sorted anew (B = 1):
    ``(tri9, cymin, cymax, cxmin, cxmax)``."""
    verts = tri9[..., :6].reshape(1, -1, 2)
    depth = tri9[..., 6:9].reshape(1, -1)
    faces = torch.arange(verts.shape[1], device=tri9.device).reshape(-1, 3)
    tri9, _, cymin, cymax, cxmin, cxmax, _ = zb._sorted_tri_z_and_ranges(
        verts, depth, faces)
    return tri9, cymin, cymax, cxmin, cxmax


@pytest.mark.parametrize("name", ["mesh128", "off_image", "nan"])
def test_coarse_level_keeps_every_padded_box(eval_scene, name):
    """Every (face, tile) whose padded box holds a pixel of the tile gets
    past the coarse level: the face's chunk lies in the band's [lo, hi)
    and its integer box, padded by MARGIN, meets the tile. So the kernel
    evaluates exactly ``support_pairs`` pairs, and a NaN vertex cannot
    drop the other faces of its chunk."""
    if name == "mesh128":
        tri9, wh = _mesh_table(eval_scene, name)
    elif name == "off_image":
        tri9, wh = _faces_table(_adversarial(name)), ADV_WH
    else:
        tri9, wh = _constructed(name), ADV_WH
    tri9, cymin, cymax, cxmin, cxmax = _glue_of(tri9)
    n_bands, n_xt = -(-wh // br.BAND_H), -(-wh // br.TILE_W)
    lo, hi = br._band_chunk_bounds(cymin, cymax, n_bands, br.BAND_H,
                                   zb.MARGIN)
    boxes = zb.face_records(tri9)[0, :, zb.BOX]
    fx, nx = br.pixel_span(boxes[:, 0], boxes[:, 1], wh)
    fy, ny = br.pixel_span(boxes[:, 2], boxes[:, 3], wh)
    held = (nx > 0) & (ny > 0)
    tiles = torch.stack([fx // br.TILE_W, (fx + nx - 1) // br.TILE_W,
                         fy // br.BAND_H, (fy + ny - 1) // br.BAND_H],
                        -1).float()
    tiles[~held] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    face, xt, band = zb.box_pairs(tiles, max(n_bands, n_xt))
    c = face // br.CHUNK
    x0 = (xt * br.TILE_W).float()
    y0 = (band * br.BAND_H).float()
    m = zb.MARGIN
    kept = ((c >= lo[0, band]) & (c < hi[0, band])
            & (cymax[0, c] >= y0 - m) & (cymin[0, c] <= y0 + br.BAND_H + m)
            & (cxmax[0, c] >= x0 - m) & (cxmin[0, c] <= x0 + br.TILE_W + m))
    assert int(held.sum()) > 0 and face.numel() >= int(held.sum())
    assert bool(kept.all())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADVERSARIAL + CONSTRUCTED)
def test_kernel_equals_plain_on_card(cuda_device, name):
    """K3 on the adversarial and constructed cases: ids and barycentrics
    bit-equal to the plain version, the same from run to run, and exactly
    the pairs inside the padded boxes evaluated."""
    tri9 = (_faces_table(_adversarial(name)) if name in ADVERSARIAL
            else _constructed(name))
    tri9, cymin, cymax, _, _ = _glue_of(tri9.to(cuda_device))
    lo, hi = br._band_chunk_bounds(cymin, cymax, -(-ADV_WH // br.BAND_H),
                                   br.BAND_H, zb.MARGIN)
    zr = zb.face_records(tri9)
    n = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    args = (zr, lo, hi, ADV_WH)
    first = zb.launch_zbuffer(*args, pair_count=n)
    again = zb.launch_zbuffer(*args)
    want = zb.rasterize_bary_plain(tri9, ADV_WH)
    for a, b, w in zip(first, again, want):
        assert torch.equal(a, w) and torch.equal(b, a)
    assert int(n) == br.support_pairs(zr[..., zb.BOX], ADV_WH)
