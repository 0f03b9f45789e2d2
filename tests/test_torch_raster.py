"""The port's rasterizer against the JAX package.

* plain ``soft_silhouette`` (+ ``cull_backfaces``) vs ``softras``: forward
  ≤ 1e-6 max abs (fp32 sums over faces in another order), gradient ≤ 1e-5
  relative L2;
* the band host glue (sort, sentinel cull, chunk boxes, [lo, hi)) equal to
  the JAX one, integers exact;
* the kernels' plain versions, through ``SoftSilhouetteBand`` on the CPU, vs
  the Pallas kernels in interpret mode: forward ≤ 1e-5 max abs and gradient
  ≤ 1e-5 relative L2 (both multiply by a per-face reciprocal of |e|²; the
  port multiplies by 1/σ where the Pallas kernels divide, and the two sum
  in other orders).

The kernels themselves against their plain versions run on a CUDA card, in
``test_torch_package.py`` (marker ``cuda``), which needs no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.render import pallas_raster as jpr  # noqa: E402
from soccerplayershapepose_tpu.render import softras as jsr  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import softras as tsr  # noqa: E402

SMALL_VERTS = np.array([[[12.3, 14.1], [42.7, 16.2], [28.9, 44.8],
                         [30.1, 20.5], [55.0, 30.0], [40.0, 55.0],
                         [5.5, 50.0], [20.0, 62.0], [2.0, 60.5]]], np.float32)
SMALL_FACES = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [2, 5, 4]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def body():
    """Full synthetic SMPL mesh (13,776 faces) projected into a 32² image,
    two samples (the second mirrored and shifted)."""
    ja = jassets.synthesize_assets()
    v = np.asarray(ja.v_template)
    rng = np.random.RandomState(0)
    wh = 32
    v2d = np.stack([v[:, 0] * wh * 0.9 + wh / 2 + rng.randn(len(v)) * 0.01,
                    -v[:, 1] * wh * 0.45 + wh / 2], -1)[None]
    v2d = np.concatenate([v2d, v2d[:, :, ::-1] + 0.3]).astype(np.float32)
    return v2d, np.array(ja.faces), wh


def _jax_plain(v2d, faces, wh, sigma, cull):
    v = jnp.asarray(v2d)
    f = jsr.cull_backfaces(v, jnp.asarray(faces)) if cull else jnp.asarray(faces)
    return jsr.soft_silhouette(v, f, wh, sigma=sigma)


def _torch_plain(v2d, faces, wh, sigma, cull):
    f = tsr.cull_backfaces(v2d, faces) if cull else faces
    return tsr.soft_silhouette(v2d, f, wh, sigma=sigma)


@pytest.mark.parametrize("case", ["small", "body"])
def test_plain_soft_silhouette_matches_jax(case, body):
    if case == "small":
        v2d, faces, wh, sigma, cull = SMALL_VERTS, SMALL_FACES, 64, 1e-4, False
    else:
        (v2d, faces, wh), sigma, cull = body, 1e-5, True
    gw = np.random.RandomState(1).randn(v2d.shape[0], wh, wh).astype(np.float32)
    want = np.asarray(_jax_plain(v2d, faces, wh, sigma, cull))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        _jax_plain(v, faces, wh, sigma, cull) * gw))(jnp.asarray(v2d)))
    vt = torch.tensor(v2d, requires_grad=True)
    got = _torch_plain(vt, torch.from_numpy(faces), wh, sigma, cull)
    got_g, = torch.autograd.grad((got * torch.from_numpy(gw)).sum(), vt)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-6
    assert _rel(got_g.numpy(), want_g) <= 1e-5
    assert 0.05 < (want > 0.5).mean() < 0.6


def test_cull_backfaces_keep_set_matches_jax(body):
    v2d, faces, _ = body
    want = np.asarray(jsr.cull_backfaces(jnp.asarray(v2d), jnp.asarray(faces)))
    got = tsr.cull_backfaces(torch.from_numpy(v2d),
                             torch.from_numpy(faces)).numpy()
    assert got.shape == want.shape == (2, int(faces.shape[0] * 0.6), 3)
    for b in range(2):
        assert {tuple(f) for f in got[b]} == {tuple(f) for f in want[b]}


@pytest.mark.parametrize("cull", [False, True])
def test_sorted_tri_and_ranges_match_jax(body, cull):
    v2d, faces, _ = body
    want = jpr._sorted_tri_and_ranges(jnp.asarray(v2d), jnp.asarray(faces), 8,
                                      cull)
    got = br._sorted_tri_and_ranges(torch.from_numpy(v2d),
                                    torch.from_numpy(faces), 8, cull)
    assert got[-1] == want[-1]
    for g, w, name in zip(got[:6], want[:6],
                          ("tri", "order", "cymin", "cymax", "cxmin", "cxmax")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_chunk_bounds_match_jax_for_any_order(seed):
    rng = np.random.RandomState(seed)
    cymin = rng.randint(-20, 200, (3, 57)).astype(np.int32)
    cymax = (cymin + rng.randint(0, 30, (3, 57))).astype(np.int32)
    cymin[:, -3:], cymax[:, -3:] = 10 ** 9, -10 ** 9          # sentinels
    margin = br.support_margin(1e-5 * 128 ** 2)
    want = jpr._band_chunk_bounds(jnp.asarray(cymin), jnp.asarray(cymax), 32,
                                  8, margin)
    got = br._band_chunk_bounds(torch.from_numpy(cymin),
                                torch.from_numpy(cymax), 32, 8, margin)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # every chunk outside [lo, hi) misses its band
    lo, hi = (x.numpy() for x in got)
    for b in range(3):
        for band in range(32):
            y0, y1 = band * 8, band * 8 + 8
            for c in range(57):
                if not lo[b, band] <= c < hi[b, band]:
                    assert cymax[b, c] < y0 - margin or cymin[b, c] > y1 + margin


def test_band_function_matches_pallas_interpret():
    """SoftSilhouetteBand on the CPU (the kernels' plain versions) vs
    ``soft_silhouette_fast`` with the Pallas kernels in interpret mode."""
    gw = np.random.RandomState(2).randn(1, 64, 64).astype(np.float32)
    faces = jnp.asarray(SMALL_FACES)

    def jfast(v):
        return jpr.soft_silhouette_fast(v, faces, 64, 1e-4, 16, 8, True, False)

    want = np.asarray(jfast(jnp.asarray(SMALL_VERTS)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfast(v) * gw))(
        jnp.asarray(SMALL_VERTS)))
    vt = torch.tensor(SMALL_VERTS, requires_grad=True)
    got = br.soft_silhouette_band(vt, torch.from_numpy(SMALL_FACES), 64, 1e-4)
    got_g, = torch.autograd.grad((got * torch.from_numpy(gw)).sum(), vt)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    assert _rel(got_g.numpy(), want_g) <= 1e-5


def test_band_function_matches_plain_on_body(body):
    """The kernels' plain versions behind the autograd Function (sort, cull
    by sentinel, un-sort, scatter onto vertices) vs autograd of the plain
    rasterizer: forward ≤ 1e-6, gradient ≤ 1e-5 relative L2."""
    v2d, faces, wh = body
    gw = torch.from_numpy(
        np.random.RandomState(3).randn(2, wh, wh).astype(np.float32))
    ft = torch.from_numpy(faces)
    va = torch.tensor(v2d, requires_grad=True)
    want = _torch_plain(va, ft, wh, 1e-5, True)
    want_g, = torch.autograd.grad((want * gw).sum(), va)
    vb = torch.tensor(v2d, requires_grad=True)
    br.reset_launch_counts()
    got = br.soft_silhouette_band(vb, ft, wh, 1e-5, backface_cull=True)
    got_g, = torch.autograd.grad((got * gw).sum(), vb)
    assert (got - want).abs().max().item() <= 1e-6
    assert _rel(got_g.numpy(), want_g.numpy()) <= 1e-5
    # CPU tensors take the plain versions: no kernel launch is counted
    assert br.LAUNCHES == {"band_raster_fwd": 0, "band_raster_bwd": 0}


def test_render_silhouette_matches_jax():
    ja = jassets.synthesize_assets()
    from soccerplayershapepose_tpu.smpl import model as jmodel
    from soccerplayershapepose_tpu.ops import camera as jcam
    from soccerplayershapepose_torch.convert import assets_from_numpy
    from soccerplayershapepose_torch.smpl import model as tmodel
    from soccerplayershapepose_torch.ops import camera as tcam
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    eye = np.tile(np.eye(3, dtype=np.float32), (1, 24, 1, 1))
    betas = np.zeros((1, 10), np.float32)
    cam = np.array([[0.9, 0.0, 0.0]], np.float32)
    jo = jmodel.smpl_forward(ja, jnp.asarray(betas), jnp.asarray(eye[:, 1:]),
                             jnp.asarray(eye[:, :1]))
    want = np.asarray(jsr.render_silhouette(
        jo.vertices, jcam.weak_perspective_to_translation(
            jnp.asarray(cam), 5000.0, 64), ja.faces, 64, 5000.0,
        render_wh=32, backface_cull=True))
    to = tmodel.smpl_forward(ta, torch.from_numpy(betas),
                             torch.from_numpy(eye[:, 1:]),
                             torch.from_numpy(eye[:, :1]))
    got = tsr.render_silhouette(
        to.vertices, tcam.weak_perspective_to_translation(
            torch.from_numpy(cam), 5000.0, 64), ta.faces, 64, 5000.0,
        render_wh=32, backface_cull=True).numpy()
    assert got.shape == (1, 32, 32)
    # vertices differ by a few fp32 ulps between the frameworks, which the
    # σ_px = 0.0026 px² sigmoid turns into up to ~1e-3 at edge pixels
    assert np.abs(got - want).max() <= 5e-3
    assert ((got > 0.5) == (want > 0.5)).mean() >= 0.998
