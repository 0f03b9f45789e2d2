"""The port's attribute renders (``render/attribute.py``:
``render_part_segmentation``, ``render_textured``), ``render/softras.py:
hard_silhouette`` and the label helpers of ``ops/segmentation.py`` against
the JAX package, at 64².

On the CPU both packages render through their dense plain z-buffer. The
part labels are the argmax of an interpolated one-hot, so a pixel near a
part boundary inside one face is a near-tie between two parts' weights,
and a pixel where two faces meet at equal depth may take either face. The
labels must be equal everywhere else: a pixel whose label differs must be
a barycentric near-tie (the two largest weights within ``TIE_W`` on
either side) or a depth tie (the depths chosen within ``K3_TIE_ULPS``);
such pixels are counted and printed, and are at most 1% of the covered
pixels. The interpolated UVs agree within 1e-6 off those pixels (XLA
contracts the barycentric sums into FMAs). The textured image is held to
1e-5 max abs off those pixels, except where the UV gap, times the normal
map's steepest texel step and its size, bounds a larger gap: a texture
with unit steps between texels (this random one) turns a 1e-7 UV gap into
~1e-5. Those pixels are counted and printed too. The masks are equal,
``hard_silhouette`` is exact and the label helpers are exact
(``joints2d_l2_error`` 1e-6).

The scenes, the texture and the tie arithmetic come from
``test_torch_attribute_render_k3.py``, which holds both renders through K3
on the card to the plain route at 128² to the same bar (marker ``cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.ops import segmentation as jseg  # noqa: E402
from soccerplayershapepose_tpu.render import attribute as jattr  # noqa: E402
from soccerplayershapepose_tpu.render import softras as jsoft  # noqa: E402

from soccerplayershapepose_torch.ops import segmentation as tseg  # noqa: E402
from soccerplayershapepose_torch.render import attribute as tattr  # noqa: E402
from soccerplayershapepose_torch.render import hard_silhouette  # noqa: E402

from test_torch_attribute_render_k3 import (  # noqa: E402
    IMG_TOL, TIE_FRAC, TIE_W, _t, body_scene, image_slope, route_ties,
    scene_attrs, texture_map)

WH = 64
UV_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_scene(seed=0, b=2, n_tri=60, wh=WH):
    """Overlapping random triangles with random depths, 7 part labels and
    UVs per vertex."""
    rs = np.random.RandomState(seed)
    v = n_tri * 3
    verts2d = rs.uniform(-4, wh + 4, (b, v, 2)).astype(np.float32)
    verts_z = rs.uniform(1, 10, (b, v)).astype(np.float32)
    faces = np.arange(v, dtype=np.int32).reshape(n_tri, 3)
    parts = rs.randint(0, 7, v).astype(np.int32)
    uv = rs.rand(v, 2).astype(np.float32)
    return verts2d, verts_z, faces, parts, uv


SCENES = {"random": random_scene, "body": lambda: body_scene(WH)}


def tie_pixels(scene, num_parts=7):
    """(label ties, depth ties, the UV gap per pixel) of the covered pixels
    between the JAX package's plain z-buffer and the port's
    (``route_ties``; another face: attributes apart by more than
    ``TIE_W``)."""
    v2d, z, faces, _, _ = scene
    attrs = scene_attrs(scene, num_parts)
    j, covered = jattr.rasterize_attributes_xla(
        jnp.asarray(v2d), jnp.asarray(z), jnp.asarray(attrs),
        jnp.asarray(faces), WH)
    t, _ = tattr.rasterize_attributes_plain(_t(v2d), _t(z), _t(attrs),
                                            _t(faces), WH)
    return route_ties(np.asarray(j), t.numpy(), np.asarray(covered), TIE_W,
                      num_parts)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_part_segmentation_matches_jax(name):
    scene = SCENES[name]()
    v2d, z, faces, parts, _ = scene
    want = np.asarray(jattr.render_part_segmentation(
        jnp.asarray(v2d), jnp.asarray(z), jnp.asarray(parts),
        jnp.asarray(faces), WH))
    got = tattr.render_part_segmentation(_t(v2d), _t(z), _t(parts),
                                         _t(faces), WH).numpy()
    assert got.shape == want.shape == (v2d.shape[0], WH, WH)
    apart = got != want
    ties, _, _ = tie_pixels(scene)
    covered = int((want > 0).sum())
    print("%s: %d of %d covered pixels apart, all near-ties: %s"
          % (name, int(apart.sum()), covered, bool((~apart | ties).all())))
    assert (~apart | ties).all()
    assert apart.sum() <= TIE_FRAC * covered
    assert len(np.unique(want)) >= 4


@pytest.mark.parametrize("name", sorted(SCENES))
def test_textured_render_matches_jax(name):
    v2d, z, faces, parts, uv = scene = SCENES[name]()
    tex = texture_map()
    want_img, want_mask = jattr.render_textured(
        jnp.asarray(v2d), jnp.asarray(z), jnp.asarray(uv),
        jnp.asarray(faces), jnp.asarray(tex.numpy()), WH)
    img, mask = tattr.render_textured(_t(v2d), _t(z), _t(uv), _t(faces),
                                      tex, WH)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    gap = np.abs(img.numpy() - np.asarray(want_img)).max(-1)
    _, ties, uv_gap = tie_pixels(scene)
    assert uv_gap[~ties].max() <= UV_TOL
    slope = image_slope(tex.numpy())
    steep = ~ties & (gap > IMG_TOL)
    print("%s: image gap %.3g off the depth ties (%d); %d pixels above "
          "%g, each within its UV gap x %.4g"
          % (name, gap[~ties].max(), int(ties.sum()), int(steep.sum()),
             IMG_TOL, slope))
    assert (gap[steep] <= IMG_TOL + slope * uv_gap[steep]).all()
    assert steep.sum() <= TIE_FRAC * mask.numpy().sum()
    assert (img.numpy()[~mask.numpy()] == 0).all()
    assert float(img.max()) > 0.5


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hard_silhouette_matches_jax(name):
    v2d, _, faces, _, _ = SCENES[name]()
    want = np.asarray(jsoft.hard_silhouette(jnp.asarray(v2d),
                                            jnp.asarray(faces), WH))
    got = hard_silhouette(_t(v2d), _t(faces), WH)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_hard_silhouette_counts_edges_and_either_winding():
    v2d = np.array([[[2.0, 2.0], [10.0, 2.0], [2.0, 10.0],
                     [20.0, 20.0], [20.0, 28.0], [28.0, 20.0]]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    got = hard_silhouette(_t(v2d), _t(faces), 32).numpy()[0]
    assert got[2, 2] == 1 and got[2, 10] == 1 and got[6, 6] == 1
    assert got[21, 21] == 1 and got[1, 1] == 0 and got[7, 7] == 0


def test_segmentation_helpers_match_jax():
    rs = np.random.RandomState(2)
    dp = rs.randint(0, 25, (3, 16, 16)).astype(np.int32)
    want = np.asarray(jseg.densepose_to_6part_lsp(jnp.asarray(dp)))
    got = tseg.densepose_to_6part_lsp(_t(dp))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    for arr in (dp, dp.astype(np.float32)):
        np.testing.assert_array_equal(
            tseg.multiclass_to_binary(_t(arr)).numpy(),
            np.asarray(jseg.multiclass_to_binary(jnp.asarray(arr))))
    pred = rs.rand(4, 17, 2).astype(np.float32) * 100
    tgt = rs.rand(4, 17, 2).astype(np.float32) * 100
    for axes in (None, -1, (0, 1)):
        np.testing.assert_allclose(
            tseg.joints2d_l2_error(_t(pred), _t(tgt), axes).numpy(),
            np.asarray(jseg.joints2d_l2_error(jnp.asarray(pred),
                                              jnp.asarray(tgt), axes)),
            rtol=1e-6, atol=0)
