"""The port's crop extraction (``pipeline/extract.py``) against the JAX
package's ``ProxyExtractor`` and helpers, on the committed
``weights/proxynet_256_f16.npz``.

Both extractors get the same uint8 batch: three 256² RGB synthetic crops
(the size the weights were trained at; at 128² the net finds nobody) and
one crop of plain grass noise, on which extraction fails. The crops are
rendered by the port with the z-buffer kernel's PyTorch mirror
(:func:`fast_rasterize_attributes`, the route the card takes), which at
256² takes about a second where the dense plain version takes about a
minute; the images are only inputs here.

* ``largest_centred_component`` and ``_flip_iuv_maps``: exact;
* the extractor, with and without flip TTA: failures identical; at most
  0.1% of the silhouette pixels differ (a mask logit within the
  forwards' fp32 gap of 0 may land either way; counted, printed); joints
  within 1e-3 px and scores within 1e-6, except at printed near-ties,
  joints whose heatmap's top two cells lie within 1e-4 (the argmax may
  go either way); IUV part ids apart at no more than 0.1% of the pixels
  (a part whose two best upsampled logits lie within the forwards' fp32
  gap may go either way; counted, printed), U, V ≤ 1e-2 on their 0-255
  scale elsewhere.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.pipeline import extract as jextract  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.pipeline import extract as textract  # noqa
from soccerplayershapepose_torch.render import zbuffer as zb  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "proxynet_256_f16.npz")
WH = 256
SIL_FRAC = 1e-3
KP_TOL = 1e-3
SCORE_TOL = 1e-6
KP_TIE = 1e-4
UV_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fast_rasterize_attributes(verts2d, verts_z, vert_attrs, faces, img_wh):
    """``rasterize_attributes`` through K3's PyTorch mirror
    (``zbuffer.rasterize_bary_pruned``), on CPU tensors: the kernel route's
    sort, face records, pruned (z, id) key minimum and gather."""
    tri9, order, *_ = zb._sorted_tri_z_and_ranges(verts2d, verts_z, faces)
    fid, w0, w1 = zb.rasterize_bary_pruned(zb.face_records(tri9), img_wh)
    w = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)
    return zb.interpolate_attributes(fid, w, order, fid >= 0, faces,
                                     vert_attrs)


def nest_flat(flat):
    """Flat flax variable names → the nested variables ``apply`` takes, in
    fp32 (what ``load_perception_weights`` gives, without its init)."""
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.asarray(arr, np.float32))
    return out


@pytest.fixture(scope="module")
def jax_variables():
    with np.load(WEIGHTS) as z:
        return nest_flat({k: z[k] for k in z.files})


@pytest.fixture(scope="module")
def port_net():
    return convert.load_proxynet_weights(WEIGHTS, "cpu")


@pytest.fixture(scope="module")
def crops():
    """(4, 256, 256, 3) uint8: three synthetic crops, then grass noise."""
    assets = synthesize_assets()
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    try:
        draws = tsynth.sample_crop_draws(torch.Generator().manual_seed(1), 3,
                                         image_wh=WH)
        image = tsynth.render_crop_batch(assets, draws, WH,
                                         with_image=True)["image"]
    finally:
        mp.undo()
    grass = np.random.RandomState(0).uniform(
        [0.1, 0.35, 0.15], [0.25, 0.5, 0.3], (1, WH, WH, 3))
    image = np.concatenate([image.numpy(), grass.astype(np.float32)])
    return (image * 255.0).astype(np.uint8)


def test_largest_centred_component_matches_jax():
    rng = np.random.RandomState(3)
    for i in range(20):
        m = (rng.rand(48, 48) > 0.6 + 0.02 * i).astype(np.float32)
        m[:, :5 + i] = 0
        want = jextract.largest_centred_component(m)
        got = textract.largest_centred_component(m)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    assert textract.largest_centred_component(np.zeros((8, 8))) is None


def test_flip_iuv_maps_matches_jax():
    rng = np.random.RandomState(4)
    part = rng.randn(2, 8, 8, 25).astype(np.float32)
    uv = rng.randn(2, 8, 8, 48).astype(np.float32)
    want = jextract._flip_iuv_maps(jnp.asarray(part), jnp.asarray(uv))
    got = textract._flip_iuv_maps(torch.from_numpy(part),
                                  torch.from_numpy(uv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert textract._KP_FLIP_PERM == jextract._KP_FLIP_PERM
    assert textract._PART_FLIP_PERM == jextract._PART_FLIP_PERM
    assert textract._UV_FLIP_PERM == jextract._UV_FLIP_PERM


def _kp_near_ties(kp_logits):
    """(B, 17) True where the heatmap's top two cells lie within KP_TIE."""
    b, h, w, k = kp_logits.shape
    top2 = np.sort(kp_logits.reshape(b, h * w, k), axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) < KP_TIE


@pytest.mark.parametrize("flip_tta", [False, True])
def test_extractor_matches_jax(crops, jax_variables, port_net, flip_tta):
    jex = jextract.ProxyExtractor(JProxyNet(), jax_variables, wh=WH,
                                  flip_tta=flip_tta)
    tex = textract.ProxyExtractor(port_net, wh=WH, flip_tta=flip_tta,
                                  device="cpu")
    want = jex(crops)
    maps = tex.forward(crops)
    got = tex.pick(*maps)
    assert len(got) == len(want) == len(crops)
    fails = [r[0] is None for r in got]
    assert fails == [r[0] is None for r in want]
    assert fails[-1] and not all(fails), fails
    ties = _kp_near_ties(maps[0].numpy())
    if flip_tta:
        ties |= _kp_near_ties(maps[1].numpy())
    for i, ((kp, sil, iuv), (jkp, jsil, jiuv)) in enumerate(zip(got, want)):
        if kp is None:
            continue
        sil_diff = np.mean(sil != jsil)
        part_apart = iuv[..., 0] != jiuv[..., 0]
        near = np.abs(kp[:, :2] - jkp[:, :2]).max(-1) > KP_TOL
        print("crop %d: silhouette %.3g apart, part ids apart %d, joints "
              "apart %d (near-ties %s)" % (i, sil_diff, part_apart.sum(),
                                           near.sum(), np.nonzero(ties[i])[0]))
        assert sil_diff <= SIL_FRAC
        assert not (near & ~ties[i]).any()
        np.testing.assert_allclose(kp[~ties[i], 2], jkp[~ties[i], 2],
                                   rtol=0, atol=SCORE_TOL)
        assert part_apart.mean() <= SIL_FRAC
        same = ~part_apart
        np.testing.assert_allclose(iuv[..., 1:][same], jiuv[..., 1:][same],
                                   rtol=0, atol=UV_TOL)
