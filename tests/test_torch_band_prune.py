"""The per-face support pruning of the band kernels K1/K2, on the CPU.

Both kernels evaluate a (face, pixel) pair only when the pixel centre lies
in the face's bounding box padded by ``support_radius(σ_px)``, a box that
``face_constants`` writes into each face's record. These tests hold the
host glue and the plain versions to that rule:

* every pair whose plain coverage D is ≥ 2e-9 lies inside its face's padded
  box, on the small scene and the 32² and 64² body scenes, at σ = 1e-5 and
  σ = 1e-4 (the self-supervised trainer's setting);
* ``support_pairs`` equals a brute-force count, NaN and sentinel boxes
  included;
* the face records equal the plain arithmetic they replace;
* the plain versions with the pairs outside the boxes dropped, as the
  kernels drop them, stay within the kernels' tolerances of the dense plain
  versions (forward ≤ 1e-6 max abs, gradient ≤ 1e-5 relative L2), and the
  plain versions behind the autograd Function stay within them of
  ``softras`` at σ = 1e-4.

The kernels themselves, and the pair counts they report, are checked on a
CUDA card (``test_torch_package.py``, marker ``cuda``; ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import softras as tsr  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

SMALL_VERTS = np.array([[[12.3, 14.1], [42.7, 16.2], [28.9, 44.8],
                         [30.1, 20.5], [55.0, 30.0], [40.0, 55.0],
                         [5.5, 50.0], [20.0, 62.0], [2.0, 60.5]]], np.float32)
SMALL_FACES = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [2, 5, 4]], np.int32)
D_DROPPED = 2e-9          # the coverage below which a pair may be dropped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    a = synthesize_assets()
    return a.v_template.numpy(), a.faces


def _scene(name, mesh):
    """(verts2d (B, V, 2), faces, wh, backface_cull) of a named scene: the
    small four-face scene at 64², or the synthetic SMPL template projected
    into a 32² or 64² image, two samples (the second mirrored and
    shifted)."""
    if name == "small":
        return (torch.from_numpy(SMALL_VERTS), torch.from_numpy(SMALL_FACES),
                64, False)
    v, faces = mesh
    wh = int(name[4:])
    rng = np.random.RandomState(0)
    v2d = np.stack([v[:, 0] * wh * 0.9 + wh / 2 + rng.randn(len(v)) * 0.01,
                    -v[:, 1] * wh * 0.45 + wh / 2], -1)[None]
    v2d = np.concatenate([v2d, v2d[:, :, ::-1] + 0.3]).astype(np.float32)
    return torch.from_numpy(v2d), faces, wh, True


def _records(name, mesh, sigma):
    v2d, faces, wh, cull = _scene(name, mesh)
    sigma_px = sigma * (wh / 2.0) ** 2
    (fc, *_), _ = br.band_inputs(v2d, faces, wh, sigma_px, cull)
    return fc, wh, sigma_px


def _in_box(fc, px, py):
    """(B, C, P) bool: pixel centre inside the face's padded box."""
    x0, x1, y0, y1 = (fc[..., i:i + 1] for i in range(16, 20))
    return (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)


@pytest.mark.parametrize("sigma", [1e-5, 1e-4])
@pytest.mark.parametrize("name", ["small", "body32", "body64"])
def test_pruning_drops_no_pair_that_matters(mesh, name, sigma):
    fc, wh, sigma_px = _records(name, mesh, sigma)
    px, py = tsr.pixel_grid(wh, fc.device)
    inv_sigma = br.inv_sigma_f32(sigma_px)
    kept = dropped_max = 0.0
    n_live = 0
    for s in range(0, fc.shape[1], 256):
        part = fc[:, s:s + 256]
        d = br.pair_coverage(part, px, py, inv_sigma)
        inside = _in_box(part, px, py)
        assert not bool(((d >= D_DROPPED) & ~inside).any())
        dropped_max = max(dropped_max, float(d[~inside].max()))
        kept += float(d[inside & (d >= D_DROPPED)].numel())
        n_live += int((part[..., 0] > -1e8).sum())
    assert dropped_max < D_DROPPED
    # the test is not vacuous: the boxes hold pairs that matter, and
    # prune most of the image
    assert kept > 0
    pairs = br.support_pairs(fc[..., br.BOX], wh)
    assert pairs < 0.25 * n_live * wh * wh


def _brute_pairs(boxes, wh):
    coords = torch.arange(wh, dtype=torch.float32)
    x0, x1, y0, y1 = (boxes[..., i, None] for i in range(4))
    nx = ((coords >= x0) & (coords <= x1)).sum(-1)
    ny = ((coords >= y0) & (coords <= y1)).sum(-1)
    return int((nx * ny).sum())


@pytest.mark.parametrize("name", ["small", "body32"])
def test_support_pairs_matches_brute_force(mesh, name):
    fc, wh, _ = _records(name, mesh, 1e-4)
    boxes = fc[..., br.BOX]
    assert br.support_pairs(boxes, wh) == _brute_pairs(boxes, wh) > 0


def test_support_pairs_edge_cases():
    """Boxes off the image, straddling its edges, between two pixel
    centres, on integer edges, sentinels and NaN sides."""
    nan = float("nan")
    boxes = torch.tensor([[-5.0, 3.0, -1.0, 0.5], [30.2, 40.0, 2.0, 2.0],
                          [3.2, 3.8, 0.0, 31.0], [0.0, 31.0, 0.0, 31.0],
                          [-1e9 - 2, -1e9 + 2, -1e9 - 2, -1e9 + 2],
                          [nan, 4.0, 0.0, 4.0], [1.0, 4.0, nan, nan],
                          [40.0, 50.0, 1.0, 2.0], [1.5, 0.5, 1.0, 3.0]])
    want = 4 * 1 + 1 * 1 + 0 + 32 * 32 + 0 + 0 + 0 + 0 + 0
    assert br.support_pairs(boxes, 32) == want
    finite = boxes[torch.isfinite(boxes).all(-1)]
    assert br.support_pairs(finite, 32) == _brute_pairs(finite, 32) == want


def test_face_constants_equal_plain_arithmetic(mesh):
    v2d, faces, wh, _ = _scene("body32", mesh)
    tri = v2d[:, faces.to(torch.long)].reshape(2, -1, 6)
    tri = torch.cat([tri, tri.new_full((2, 3, 6), br.SENTINEL)], 1)
    radius = br.support_radius(1e-5 * (wh / 2.0) ** 2)
    fc = br.face_constants(tri, radius)
    assert fc.shape == (2, tri.shape[1], br.REC) and fc.is_contiguous()
    ax, ay, bx, by, cx, cy = tri.unbind(-1)
    assert torch.equal(fc[..., :6], tri)
    edges = [(bx - ax, by - ay), (cx - bx, cy - by), (ax - cx, ay - cy)]
    for k, (ex, ey) in enumerate(edges):
        assert torch.equal(fc[..., 6 + 2 * k], ex)
        assert torch.equal(fc[..., 7 + 2 * k], ey)
        assert torch.equal(fc[..., 12 + k],
                           1.0 / torch.clamp(ex * ex + ey * ey, min=1e-12))
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    assert torch.equal(fc[..., 15], (torch.abs(area) > 1e-9).float())
    xs, ys = tri[..., 0::2], tri[..., 1::2]
    for i, want in enumerate((xs.amin(-1) - radius, xs.amax(-1) + radius,
                              ys.amin(-1) - radius, ys.amax(-1) + radius)):
        assert torch.equal(fc[..., 16 + i], want)
    # sentinels: degenerate, boxes far off the image
    assert (fc[:, -3:, 15] == 0).all() and (fc[:, -3:, 17] < -1e8).all()
    # the pair terms differ from softras's only in the projection, which
    # multiplies by 1/|e|² where softras divides
    px, py = tsr.pixel_grid(wh, tri.device)
    sl = slice(0, 300)
    got, inside, nondeg = br.pair_terms(fc[:, sl], px, py)
    want, w_inside, w_nondeg = tsr.triangle_terms(
        px, py, tri[:, sl].reshape(2, -1, 3, 2))
    assert torch.equal(inside, w_inside)
    assert torch.equal(nondeg > 0, w_nondeg)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])                      # cross
        torch.testing.assert_close(g[2], w[2], rtol=3e-7, atol=3e-7)  # t


@pytest.mark.parametrize("sigma", [1e-5, 1e-4])
def test_pruned_plain_forward_within_kernel_tolerance(mesh, sigma):
    """Dropping the pairs outside the padded boxes moves S by far less
    than K1's 1e-6."""
    fc, wh, sigma_px = _records("body32", mesh, sigma)
    px, py = tsr.pixel_grid(wh, fc.device)
    inv_sigma = br.inv_sigma_f32(sigma_px)
    acc = torch.zeros((fc.shape[0], wh * wh))
    for s in range(0, fc.shape[1], 256):
        part = fc[:, s:s + 256]
        d = br.pair_coverage(part, px, py, inv_sigma)
        acc = acc + torch.sum(torch.log1p(-torch.where(
            _in_box(part, px, py), d, 0.0)), 1)
    pruned = (1.0 - torch.exp(acc)).reshape(-1, wh, wh)
    dense = br.band_raster_fwd_plain(fc, wh, sigma_px)
    assert (pruned - dense).abs().max().item() <= 1e-6


@pytest.mark.parametrize("sigma", [1e-5, 1e-4])
def test_pruned_plain_gradient_within_kernel_tolerance(mesh, sigma):
    """Per face, the gradient summed over the pixels in its padded box (what
    K2 sums) against the dense sum: ≤ 1e-5 relative L2."""
    fc, wh, sigma_px = _records("small", mesh, sigma)
    gs = torch.from_numpy(np.random.RandomState(4).randn(
        1, wh, wh).astype(np.float32))
    dense = br.band_raster_bwd_plain(fc, gs, wh, sigma_px)
    px, py = tsr.pixel_grid(wh, fc.device)
    pruned = []
    for f in range(fc.shape[1]):
        rec = fc[:, f:f + 1]
        keep = _in_box(rec, px, py).reshape(1, wh, wh)
        pruned.append(br.band_raster_bwd_plain(
            rec, torch.where(keep, gs, 0.0), wh, sigma_px))
    pruned = torch.cat(pruned, 1)
    assert (torch.linalg.vector_norm(pruned - dense)
            / torch.linalg.vector_norm(dense)).item() <= 1e-5


def test_band_function_matches_softras_at_wide_support(mesh):
    """At σ = 1e-4 (``test_torch_raster.py`` covers σ = 1e-5), the plain
    versions, with their per-face reciprocal and 1/σ product, behind the
    autograd Function against autograd of ``softras``: forward ≤ 1e-6 max
    abs, gradient ≤ 1e-5 relative L2."""
    sigma = 1e-4
    v2d, faces, wh, _ = _scene("body32", mesh)
    gw = torch.from_numpy(
        np.random.RandomState(3).randn(2, wh, wh).astype(np.float32))
    va = v2d.clone().requires_grad_(True)
    want = tsr.soft_silhouette(va, tsr.cull_backfaces(va, faces), wh,
                               sigma=sigma)
    want_g, = torch.autograd.grad((want * gw).sum(), va)
    vb = v2d.clone().requires_grad_(True)
    got = br.soft_silhouette_band(vb, faces, wh, sigma, backface_cull=True)
    got_g, = torch.autograd.grad((got * gw).sum(), vb)
    assert (got - want).abs().max().item() <= 1e-6
    assert (torch.linalg.vector_norm(got_g - want_g)
            / torch.linalg.vector_norm(want_g)).item() <= 1e-5
