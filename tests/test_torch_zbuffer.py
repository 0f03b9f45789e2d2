"""The port's hard z-buffer against the JAX package.

* the kernel's plain version ``rasterize_bary_plain`` (through
  ``rasterize_bary`` on the CPU) vs the Pallas z-buffer in interpret mode:
  identical sorted face ids and mask, barycentrics ≤ 1e-5 max abs. The
  steps are the same, but XLA's CPU backend contracts each edge function's
  a·b − c·d into a fused multiply-add where the port (and K3, which must
  match the port exactly) rounds both products; on a thin triangle (twice
  the area 2 px², products near 1e2) that moves a barycentric by 1.4e-6;
* ``rasterize_attributes_plain`` vs ``rasterize_attributes_xla`` on
  identical vertices: identical mask, attributes ≤ 1e-6 max abs;
* the host glue (sort order, the [xyxyxy|zzz] table, chunk boxes, band
  bounds) equal to the JAX glue, exactly;
* the sorted route against the original-order oracle on an exact depth
  tie: they take different faces only there, and there the depths they
  chose agree within 8 ulps, the rule ``chip_smoke.py`` holds K3's route to.

The kernel itself against its plain version runs on a CUDA card, in
``test_torch_package.py`` (marker ``cuda``), which needs no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.render import attribute as jattr  # noqa: E402
from soccerplayershapepose_tpu.render import pallas_raster as jpr  # noqa: E402
from soccerplayershapepose_tpu.render import pallas_zbuffer as jzb  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch.render import attribute as tattr  # noqa: E402
from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import zbuffer as tzb  # noqa: E402

W_TOL = 1e-5        # XLA's FMA contraction, see the module docstring
ATTR_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_scene(b=2, n_tri=40, wh=64, seed=0):
    """Small, mostly disjoint triangles with per-vertex depths."""
    rng = np.random.RandomState(seed)
    v = n_tri * 3
    verts = rng.uniform(-8, wh + 8, (b, n_tri, 3, 2)).astype(np.float32)
    cen = verts.mean(axis=2, keepdims=True)
    verts = (cen + (verts - cen) * rng.uniform(0.2, 0.9)).reshape(b, v, 2)
    z = rng.uniform(1.0, 9.0, (b, v)).astype(np.float32)
    attrs = rng.rand(b, v, 5).astype(np.float32)
    faces = np.arange(v, dtype=np.int32).reshape(n_tri, 3)
    return verts.astype(np.float32), z, attrs, faces, wh


def _two_bodies(wh=32):
    """Two overlapping full synthetic SMPL meshes (2 × 13,776 faces): the
    template projected into a wh² image and the same body shifted by 3 px
    and 0.05 nearer, in two samples (the second mirrored)."""
    ja = jassets.synthesize_assets()
    v = np.asarray(ja.v_template)
    faces = np.asarray(ja.faces)
    rng = np.random.RandomState(1)
    v2d = np.stack([v[:, 0] * wh * 0.9 + wh / 2 + rng.randn(len(v)) * 0.01,
                    -v[:, 1] * wh * 0.45 + wh / 2], -1)
    z = v[:, 2] + 5.0
    scene = np.concatenate([v2d, v2d + [3.0, 0.5]])[None]
    scene = np.concatenate([scene, wh - scene[:, :, ::-1]]).astype(np.float32)
    zz = np.concatenate([z, z - 0.05])[None].repeat(2, 0).astype(np.float32)
    f2 = np.concatenate([faces, faces + len(v)]).astype(np.int32)
    attrs = np.random.RandomState(2).rand(2, 2 * len(v), 3).astype(np.float32)
    return scene, zz, attrs, f2, wh


def _one_body(wh=32):
    """One full mesh: 1,722 chunks, below the 2,048 at which the JAX glue
    starts to group chunk boxes, so its boxes are exact per chunk."""
    scene, zz, attrs, f2, wh = _two_bodies(wh)
    n = f2.shape[0] // 2
    nv = scene.shape[1] // 2
    return scene[:, :nv], zz[:, :nv], attrs[:, :nv], f2[:n], wh


SCENES = {"small": _random_scene, "bodies": _two_bodies}


@pytest.fixture(scope="module")
def pallas_bary():
    """JAX's Pallas z-buffer (interpret mode) on each scene."""
    out = {}
    for name, make in SCENES.items():
        verts, z, _, faces, wh = make()
        fid, w, order, mask = jzb.rasterize_bary_pallas(
            jnp.asarray(verts), jnp.asarray(z), jnp.asarray(faces), wh,
            band_h=8, interpret=True)
        out[name] = tuple(np.asarray(x) for x in (fid, w, order, mask))
    return out


@pytest.fixture(scope="module")
def xla_attributes():
    out = {}
    for name, make in SCENES.items():
        verts, z, attrs, faces, wh = make()
        a, m = jattr.rasterize_attributes_xla(
            jnp.asarray(verts), jnp.asarray(z), jnp.asarray(attrs),
            jnp.asarray(faces), wh)
        out[name] = (np.asarray(a), np.asarray(m))
    return out


@pytest.mark.parametrize("case", list(SCENES))
def test_plain_bary_matches_pallas_interpret(case, pallas_bary):
    verts, z, _, faces, wh = SCENES[case]()
    fid, w, order, mask = tzb.rasterize_bary(
        torch.from_numpy(verts), torch.from_numpy(z), torch.from_numpy(faces),
        wh)
    jfid, jw, jorder, jmask = pallas_bary[case]
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(fid.numpy(), jfid)
    assert mask.any() and not mask.all()
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=W_TOL)


@pytest.mark.parametrize("case", list(SCENES))
def test_plain_attributes_match_xla(case, xla_attributes):
    verts, z, attrs, faces, wh = SCENES[case]()
    out, mask = tattr.rasterize_attributes_plain(
        torch.from_numpy(verts), torch.from_numpy(z), torch.from_numpy(attrs),
        torch.from_numpy(faces), wh)
    ref, rmask = xla_attributes[case]
    np.testing.assert_array_equal(mask.numpy(), rmask)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATTR_TOL)


@pytest.mark.parametrize("case", ["small", "one_body"])
def test_host_glue_matches_jax(case):
    """Sort order, the table, the exact chunk boxes and the band bounds."""
    make = {"small": _random_scene, "one_body": _one_body}[case]
    verts, z, _, faces, wh = make()
    got = tzb._sorted_tri_z_and_ranges(torch.from_numpy(verts),
                                       torch.from_numpy(z),
                                       torch.from_numpy(faces))
    want = jzb._sorted_tri_z_and_ranges(jnp.asarray(verts), jnp.asarray(z),
                                        jnp.asarray(faces), 8)
    assert want[7] == 1 and got[6] == want[6]          # group 1: exact boxes
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_bands = -(-wh // 8)
    lo, hi = br._band_chunk_bounds(got[2], got[3], n_bands, 8, tzb.MARGIN)
    jlo, jhi = jpr._band_chunk_bounds(want[2], want[3], n_bands, 8,
                                      tzb.MARGIN)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_fast_attributes_on_cpu_match_plain():
    """The sorted-id gather of ``rasterize_attributes_fast`` (plain kernel
    version on the CPU) against the original-order plain oracle: identical
    mask; the attributes agree except where two faces tie in z and the
    orders pick different ones (none in this scene)."""
    verts, z, attrs, faces, wh = _random_scene(seed=4)
    args = (torch.from_numpy(verts), torch.from_numpy(z),
            torch.from_numpy(attrs), torch.from_numpy(faces), wh)
    out, mask = tzb.rasterize_attributes_fast(*args)
    ref, rmask = tattr.rasterize_attributes_plain(*args)
    assert torch.equal(mask, rmask) and mask.any()
    assert (out - ref).abs().max().item() <= ATTR_TOL
    out2, mask2 = tattr.rasterize_attributes(*args)    # CPU: the plain path
    assert torch.equal(out2, ref) and torch.equal(mask2, rmask)


def test_fast_and_plain_attributes_differ_only_at_depth_ties():
    """Two coplanar triangles at one depth, listed against their y-order:
    the sorted route takes the first in y, the oracle the first listed, so
    their overlap differs, and there the depths each chose (a last
    attribute channel) are equal. Elsewhere the attributes agree."""
    verts = np.array([[[4, 20], [28, 20], [16, 2], [4, 4], [28, 4], [16, 30]]],
                     np.float32)
    z = np.full((1, 6), 5.0, np.float32)
    attrs = np.array([[[1.0], [1.0], [1.0], [0.0], [0.0], [0.0]]], np.float32)
    faces = np.array([[3, 4, 5], [0, 1, 2]], np.int32)
    v, zt, a, f = (torch.from_numpy(x) for x in (verts, z, attrs, faces))
    az = torch.cat([a, zt[..., None]], dim=-1)
    out, mask = tzb.rasterize_attributes_fast(v, zt, az, f, 32)
    ref, rmask = tattr.rasterize_attributes_plain(v, zt, az, f, 32)
    assert torch.equal(mask, rmask)
    apart = (out[..., :1] - ref[..., :1]).abs().amax(-1) > ATTR_TOL
    assert apart.sum() > 20
    assert (out[..., 0][apart] - 1.0).abs().max().item() <= ATTR_TOL
    assert ref[..., 0][apart].abs().max().item() <= ATTR_TOL
    z_k, z_p = out[..., 1][apart], ref[..., 1][apart]
    ulp = torch.nextafter(z_p, torch.full_like(z_p, np.inf)) - z_p
    assert ((z_k - z_p).abs() / ulp).max().item() <= 8
    assert (out[~apart] - ref[~apart]).abs().max().item() <= ATTR_TOL


def test_plain_bary_tie_goes_to_smallest_sorted_id():
    """Two copies of one face at one depth: the first in sorted order wins,
    as in the Pallas kernel and K3."""
    verts = torch.tensor([[[2.0, 2.0], [14.0, 3.0], [6.0, 13.0]]]).repeat(
        1, 2, 1)
    z = torch.ones(1, 6)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    fid, w, order, mask = tzb.rasterize_bary(verts, z, faces, 16)
    assert mask.any()
    assert set(fid[mask].tolist()) == {0}
    assert order.tolist() == [[0, 1]]


def test_offscreen_faces_fall_out_of_band_ranges():
    """Faces moved by +1e5 px (an absent occluder) sort after the visible
    ones and lie outside every band's [lo, hi); the boxes stay in int32."""
    verts, z, _, faces, wh = _random_scene(b=1, n_tri=16)
    far = verts + 1e5
    scene = np.concatenate([verts, far], axis=1)
    zz = np.concatenate([z, z], axis=1)
    f2 = np.concatenate([faces, faces + verts.shape[1]])
    tri9, order, cymin, cymax, cxmin, cxmax, n_chunks = \
        tzb._sorted_tri_z_and_ranges(torch.from_numpy(scene),
                                     torch.from_numpy(zz),
                                     torch.from_numpy(f2))
    assert (order[0, 16:] >= 16).all()
    lo, hi = br._band_chunk_bounds(cymin, cymax, wh // 8, 8, tzb.MARGIN)
    assert int(hi.max()) <= 2 and int(cymin[0, 2:].min()) > 99_000
    fid, _, _, mask = tzb.rasterize_bary(
        torch.from_numpy(scene), torch.from_numpy(zz), torch.from_numpy(f2),
        wh)
    assert int(fid.max()) < 16 and mask.any()
