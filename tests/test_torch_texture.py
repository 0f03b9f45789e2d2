"""The port's texture extraction (``texture/uv.py``) and texture quality
probe (``texture/quality.py``) against the JAX package, on numpy-seeded
inputs.

* ``iuv_to_atlas_texture`` on random IUVs at 64², part_res 200 and 16,
  U/V in [0, 1] and in [0, 255]: texel means ≤ 1e-6 max abs, masks
  equal. A texel index ``round(u·(R − 1))`` that lies at .5 could round
  the other way in one framework; the texels covered on one side only are
  counted as flips, printed, and must be 0 here, including the exact
  half-texel case at part_res 17 (both round half to even);
* the batched form equals JAX's ``vmap``;
* ``fuse_atlas_textures``, ``concat_atlas``, ``split_atlas``,
  ``sample_uv_texture``: ≤ 1e-6;
* ``atlas_to_normal`` / ``normal_to_atlas`` with the procedural tiling,
  a dense-dict mapping pickle and a reference relation-list pickle, each
  written to ``tmp_path``: ≤ 1e-6. A relation list's targets are unique
  here: with repeated targets the winner of ``.at[].set`` and of an index
  put is unspecified in both frameworks;
* the probe's arithmetic (``texture_metrics``, ``downsample``) on identical
  images and IUVs against the script's formulas (``scripts/
  texture_probe.py``, written out with the JAX package's functions):
  ≤ 1e-5 relative on the dB metrics, 1e-6 on the others; the downsample
  ≤ 1e-6 against ``jax.image.resize(..., "linear")``;
* ``texture_quality`` end to end on the CPU (one batch of two 256² crops,
  K3's PyTorch mirror for the renders): finite, in range, and the fused
  predicted atlas it returns is zero off its mask.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.texture import uv as juv  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.texture import quality as tq  # noqa: E402
from soccerplayershapepose_torch.texture import uv as tuv  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import fast_rasterize_attributes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
DB_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def random_iuv(rs, shape=(64, 64), scale=1.0, bg=0.3):
    part = rs.randint(1, 25, shape).astype(np.float32)
    part[rs.rand(*shape) < bg] = 0
    uv = rs.rand(*shape, 2).astype(np.float32) * np.float32(scale)
    return np.concatenate([part[..., None], uv], -1)


def assert_atlas_match(got, want):
    (tex, mask), (jtex, jmask) = got, want
    jtex, jmask = np.asarray(jtex), np.asarray(jmask)
    flips = int((mask.numpy() != jmask).sum())
    print("texels covered on one side only:", flips)
    assert flips == 0
    np.testing.assert_allclose(tex.numpy(), jtex, rtol=0, atol=TOL)


@pytest.mark.parametrize("part_res", [200, 16])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_iuv_to_atlas_matches_jax(part_res, scale):
    rs = np.random.RandomState(part_res + int(scale))
    img = rs.rand(64, 64, 3).astype(np.float32)
    iuv = random_iuv(rs, scale=scale)
    want = juv.iuv_to_atlas_texture(jnp.asarray(img), jnp.asarray(iuv),
                                    part_res)
    got = tuv.iuv_to_atlas_texture(_t(img), _t(iuv), part_res)
    assert got[0].shape == (24, part_res, part_res, 3)
    assert_atlas_match(got, want)
    # Collisions average: fewer texels than pixels at part_res 16.
    if part_res == 16:
        assert got[1].sum() < (iuv[..., 0] > 0).sum()


def test_half_texel_indices_round_alike():
    """part_res 17: u·16 is exact, so u = (k + 0.5)/16 lies at .5."""
    rs = np.random.RandomState(3)
    k = rs.randint(0, 16, (32, 32, 2))
    iuv = np.concatenate([rs.randint(1, 25, (32, 32, 1)),
                          (k + 0.5) / 16.0], -1).astype(np.float32)
    img = rs.rand(32, 32, 3).astype(np.float32)
    want = juv.iuv_to_atlas_texture(jnp.asarray(img), jnp.asarray(iuv), 17)
    got = tuv.iuv_to_atlas_texture(_t(img), _t(iuv), 17)
    assert_atlas_match(got, want)
    # Half to even: 2.5 → 2, 3.5 → 4.
    valid, idx = tuv.texel_index(_t(iuv[:1, :1]), 17)
    row = int(idx) // 17 % 17
    half = float(iuv[0, 0, 1] * 16)
    assert row == int(np.round(half))


def test_batched_atlas_equals_jax_vmap():
    rs = np.random.RandomState(5)
    img = rs.rand(3, 32, 32, 3).astype(np.float32)
    iuv = np.stack([random_iuv(rs, (32, 32)) for _ in range(3)])
    want = jax.vmap(juv.iuv_to_atlas_texture)(jnp.asarray(img),
                                              jnp.asarray(iuv))
    got = tuv.iuv_to_atlas_texture(_t(img), _t(iuv))
    assert got[0].shape == (3, 24, 200, 200, 3)
    assert_atlas_match(got, want)


def test_fuse_concat_split_sample_match_jax():
    rs = np.random.RandomState(7)
    tex = rs.rand(3, 24, 16, 16, 3).astype(np.float32)
    mask = (rs.rand(3, 24, 16, 16) > 0.5).astype(np.float32)
    want = juv.fuse_atlas_textures(jnp.asarray(tex), jnp.asarray(mask))
    got = tuv.fuse_atlas_textures(_t(tex), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    sheet = juv.concat_atlas(jnp.asarray(tex[0]))
    tsheet = tuv.concat_atlas(_t(tex[0]))
    np.testing.assert_array_equal(tsheet.numpy(), np.asarray(sheet))
    np.testing.assert_array_equal(tuv.split_atlas(tsheet, 16).numpy(),
                                  np.asarray(juv.split_atlas(sheet, 16)))
    # One channel and a 2-D per-part mask too.
    np.testing.assert_array_equal(
        tuv.concat_atlas(_t(mask[0])).numpy(),
        np.asarray(juv.concat_atlas(jnp.asarray(mask[0]))))
    uv = rs.uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tuv.sample_uv_texture(tsheet, _t(uv)).numpy(),
        np.asarray(juv.sample_uv_texture(sheet, jnp.asarray(uv))),
        rtol=0, atol=TOL)


def write_dict_mapping(path, normal_res, part_res, rs):
    m = {"part": rs.randint(0, 24, (normal_res, normal_res)),
         "y": rs.randint(0, part_res, (normal_res, normal_res)),
         "x": rs.randint(0, part_res, (normal_res, normal_res))}
    with open(path, "wb") as f:
        pickle.dump(m, f)


def write_relation_list(path, n, dst_shape, src_shape, dst_first, rs):
    """n entries with unique targets: [dst..., src...] or [src..., dst...]
    in the reference's column order."""
    dst = np.stack(np.unravel_index(
        rs.choice(int(np.prod(dst_shape)), n, replace=False), dst_shape), -1)
    src = np.stack([rs.randint(0, s, n) for s in src_shape], -1)
    rel = np.concatenate([dst, src] if dst_first else [src, dst], -1)
    with open(path, "wb") as f:
        pickle.dump(rel.tolist(), f)
    return rel


@pytest.mark.parametrize("layout", ["procedural", "dict", "list"])
def test_atlas_normal_conversions_match_jax(layout, tmp_path):
    rs = np.random.RandomState(11)
    r, res = 16, 96
    atlas = rs.rand(24, r, r, 3).astype(np.float32)
    normal = rs.rand(res, res, 3).astype(np.float32)
    a2n = n2a = None
    if layout == "dict":
        a2n = str(tmp_path / "a2n.pickle")
        write_dict_mapping(a2n, res, r, rs)
        n2a = a2n
    elif layout == "list":
        a2n = str(tmp_path / "a2n.pickle")
        n2a = str(tmp_path / "n2a.pickle")
        # atlas2normal: [normal_y, normal_x, part, atlas_i, atlas_j]
        write_relation_list(a2n, 2000, (res, res), (24, r, r), True, rs)
        # normal2atlas: [atlas_i, atlas_j, part, normal_y, normal_x]; the
        # unique targets are (part, i, j), written as (i, j, part).
        rel = write_relation_list(n2a, 2000, (24, r, r), (res, res), True,
                                  rs)
        rel = rel[:, [1, 2, 0, 3, 4]]
        with open(n2a, "wb") as f:
            pickle.dump(rel.tolist(), f)
    want = juv.atlas_to_normal(jnp.asarray(atlas), res, a2n)
    got = tuv.atlas_to_normal(_t(atlas), res, a2n)
    assert got.shape == (res, res, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    want = juv.normal_to_atlas(jnp.asarray(normal), r, n2a)
    got = tuv.normal_to_atlas(_t(normal), r, n2a)
    assert got.shape == (24, r, r, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    if layout == "list":
        assert (got.numpy() == 0).any() and (got.numpy() != 0).any()


def test_mapping_pickle_of_another_shape_is_refused(tmp_path):
    path = str(tmp_path / "bad.pickle")
    with open(path, "wb") as f:
        pickle.dump([[1, 2, 3]], f)
    with pytest.raises(ValueError):
        tuv.atlas_to_normal(torch.zeros(24, 4, 4, 3), 24, path)


def jax_probe_metrics(img, iuv_gt, iuv_pred):
    """The cell of ``scripts/texture_probe.py`` from its resized image and
    two IUVs, with the JAX package's functions."""
    def tex_coords(iuv):
        part = jnp.round(iuv[..., 0]).astype(jnp.int32)
        u = iuv[..., 1].astype(jnp.float32)
        v = iuv[..., 2].astype(jnp.float32)
        u = jnp.where(u > 1.5, u / 255.0, u)
        v = jnp.where(v > 1.5, v / 255.0, v)
        valid = part > 0
        pi = jnp.clip(part - 1, 0, juv.NUM_PARTS - 1)
        r = jnp.clip(jnp.round(u * (juv.PART_RES - 1)), 0,
                     juv.PART_RES - 1).astype(jnp.int32)
        c = jnp.clip(jnp.round(v * (juv.PART_RES - 1)), 0,
                     juv.PART_RES - 1).astype(jnp.int32)
        return valid, (pi * juv.PART_RES + r) * juv.PART_RES + c

    def roundtrip_psnr(img, iuv):
        tex, _ = juv.iuv_to_atlas_texture(img, iuv)
        valid, idx = tex_coords(iuv)
        recon = tex.reshape(-1, 3)[idx]
        err = jnp.sum(((recon - img) ** 2) * valid[..., None]) \
            / jnp.maximum(jnp.sum(valid) * 3, 1)
        return 10.0 * jnp.log10(1.0 / jnp.maximum(err, 1e-10))

    tex_gt, m_gt = jax.vmap(juv.iuv_to_atlas_texture)(img, iuv_gt)
    tex_pr, m_pr = jax.vmap(juv.iuv_to_atlas_texture)(img, iuv_pred)
    inter = m_gt * m_pr
    l1 = jnp.sum(jnp.abs(tex_gt - tex_pr) * inter[..., None]) \
        / jnp.maximum(jnp.sum(inter) * 3, 1)
    mse = jnp.sum(((tex_gt - tex_pr) ** 2) * inter[..., None]) \
        / jnp.maximum(jnp.sum(inter) * 3, 1)
    return {"gt_roundtrip_psnr_db": jnp.mean(
                jax.vmap(roundtrip_psnr)(img, iuv_gt)),
            "pred_roundtrip_psnr_db": jnp.mean(
                jax.vmap(roundtrip_psnr)(img, iuv_pred)),
            "pred_vs_gt_l1": l1,
            "pred_vs_gt_psnr_db": 10.0 * jnp.log10(
                1.0 / jnp.maximum(mse, 1e-10)),
            "coverage_gt": jnp.mean(m_gt), "coverage_pred": jnp.mean(m_pr),
            "coverage_inter": jnp.mean(inter)}


def test_probe_arithmetic_matches_the_script():
    rs = np.random.RandomState(13)
    big = rs.rand(2, 256, 256, 3).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(big), (2, 64, 64, 3),
                                      "linear"))
    down = tq.downsample(_t(big), 64).numpy()
    np.testing.assert_allclose(down, img, rtol=0, atol=TOL)
    iuv_gt = np.stack([random_iuv(rs) for _ in range(2)])
    # The prediction: the ground truth with a share of its pixels moved,
    # U and V on decode_iuv's 0..255 scale.
    iuv_pred = iuv_gt.copy()
    iuv_pred[..., 1:] = np.clip(iuv_pred[..., 1:] + rs.normal(
        0, 0.01, iuv_pred[..., 1:].shape), 0, 1) * 255
    iuv_pred[..., 1:] *= (iuv_pred[..., :1] > 0)
    want = jax_probe_metrics(jnp.asarray(img), jnp.asarray(iuv_gt),
                             jnp.asarray(iuv_pred))
    got = tq.texture_metrics(_t(img), _t(iuv_gt), _t(iuv_pred))
    assert set(got) == set(want)
    for k in got:
        g, w = float(got[k]), float(want[k])
        tol = DB_REL * abs(w) if k.endswith("_db") else TOL
        assert abs(g - w) <= tol, (k, g, w)
    assert float(want["coverage_inter"]) > 0


def test_texture_quality_runs_on_cpu(monkeypatch):
    """One batch of two 256² crops (the committed ProxyNet finds nothing
    in smaller crops), rendered through K3's PyTorch mirror."""
    monkeypatch.setattr(tsynth, "rasterize_attributes",
                        fast_rasterize_attributes)
    assets = synthesize_assets()
    net = convert.load_proxynet_weights(
        os.path.join(REPO, "weights", "proxynet_256_f16.npz"), "cpu")
    times = {}
    res = tq.texture_quality(net, assets, n_batches=1, batch=2,
                             stage_times=times, device="cpu")
    atlas, atlas_mask = res.pop("pred_atlas"), res.pop("pred_atlas_mask")
    print(res, times)
    assert res["n_crops"] == 2 and res["grid"] == 64
    assert set(times) == {"synthesis", "proxynet", "scatter"}
    assert all(np.isfinite(v) for v in res.values())
    assert atlas.shape == (24, 200, 200, 3) and atlas_mask.shape == (24, 200,
                                                                     200)
    assert 0 < float(atlas_mask.mean()) <= res["coverage_pred"] * 2
    assert bool(((atlas == 0).all(-1) | (atlas_mask > 0)).all())
    assert 0 < res["coverage_gt"] < 0.01 and 0 < res["coverage_pred"] < 0.01
    assert res["gt_roundtrip_psnr_db"] > 20
