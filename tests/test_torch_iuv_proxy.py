"""The IUV half of the port's ``train/straps.py`` against the JAX package:
the ground-truth IUV image, the 20- and 21-channel proxies, the channel
expansion of the committed regressor and a 21-channel evaluation.

* ``gt_iuv_image`` with and without a mask: ≤ 1e-6 max abs (nearest ×4
  for the part labels, bilinear with half-pixel centres for U, V);
* the 20- and 21-channel proxies of ``synth_regressor_batch`` (corrupted,
  so the cut-out silhouette masks the IUV) on JAX's draws at 64²: built
  from JAX's own labels (the same scene), ≤ 1e-5; end to end from the
  draws, the two SMPL forwards place vertices fp32 ulps apart (ROADMAP
  "Faults"), so proxy pixels may differ where the labels differ: counted,
  ≤ 1% of the proxy's pixels, and ≤ 1e-5 everywhere else;
* ``expand_regressor_channels``: the port's npz equals JAX's key for key,
  bit for bit;
* the 21-channel expanded regressor on a 21-channel proxy equals the
  18-channel one on its first 18 channels (≤ 1e-5);
* ``evaluate_regressor`` at 21 channels on one batch of two 64² crops
  from JAX's draws: ≤ 1e-4 relative per metric.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import regressor as jreg  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.ief import (  # noqa: E402
    default_initial_params)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402

from test_torch_synth_eval import _nest, jax_crop_draws  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
B, WH = 2, 64
IUV_TOL = 1e-6
PROXY_TOL = 1e-5
PX_FRAC = 1e-2
MODEL_TOL = 1e-5
EVAL_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_corruption_draws(rng, b, wh):
    """The draws of ``jstraps.corrupt_proxy_inputs(rng, ...)``."""
    k_jit, k_drop, k_cut, k_score = jax.random.split(rng, 4)
    cuts = [jax.random.split(jax.random.fold_in(k_cut, c), 3)
            for c in range(tstraps.MAX_CUTOUTS)]
    u = jax.random.uniform
    return tstraps.CorruptionDraws(
        jitter=_t(jax.random.normal(k_jit, (b, 17, 2))),
        dropped=_t(jax.random.bernoulli(k_drop, tstraps.DROP_P, (b, 17))),
        score_noise=_t(jax.random.normal(k_score, (b, 17))),
        cut_active=_t(np.stack([np.asarray(jax.random.bernoulli(
            k1, tstraps.CUTOUT_P, (b, 1, 1)))[:, 0, 0]
            for k1, _, _ in cuts])),
        cut_centre=_t(np.stack([u(k2, (b, 2), minval=0.0, maxval=wh)
                                for _, k2, _ in cuts])),
        cut_half=_t(np.stack([u(k3, (b, 2), minval=0.03 * wh,
                                maxval=0.5 * tstraps.CUTOUT_FRAC * wh)
                              for _, _, k3 in cuts])))


def jax_regressor_draws(rng, b, wh):
    """The draws of ``jstraps.synth_regressor_batch(rng, b, wh)``."""
    k_synth, k_corrupt = jax.random.split(rng)
    return tstraps.RegressorDraws(jax_crop_draws(k_synth, b),
                                  jax_corruption_draws(k_corrupt, b, wh))


@pytest.fixture(scope="module")
def jassets_():
    return jassets.synthesize_assets()


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def expanded(tmp_path_factory):
    """The committed 18-channel weights expanded to 20 and 21 channels by
    each package: {(package, channels): path}."""
    d = tmp_path_factory.mktemp("expanded")
    out = {}
    for c in (20, 21):
        for pkg, fn in (("jax", jstraps.expand_regressor_channels),
                        ("port", tstraps.expand_regressor_channels)):
            out[pkg, c] = str(d / ("%s_%d.npz" % (pkg, c)))
            fn(WEIGHTS, out[pkg, c], c)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_gt_iuv_image_matches_jax(masked):
    rs = np.random.RandomState(int(masked))
    part = rs.randint(0, 25, (3, 16, 16)).astype(np.int32)
    uv = rs.rand(3, 16, 16, 2).astype(np.float32)
    mask = (rs.rand(3, 64, 64) > 0.3).astype(np.float32) if masked else None
    want = np.asarray(jstraps.gt_iuv_image(
        jnp.asarray(part), jnp.asarray(uv), 64,
        None if mask is None else jnp.asarray(mask)))
    got = tstraps.gt_iuv_image(_t(part), _t(uv), 64,
                               None if mask is None else _t(mask)).numpy()
    assert got.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=IUV_TOL)
    assert got[..., 0].max() <= 24 / 255 + 1e-7
    assert (got[..., 1:][got[..., 0] == 0] == 0).all()


def test_expanded_weights_equal_jax_bit_for_bit(expanded):
    for c in (20, 21):
        with np.load(expanded["jax", c]) as zj, \
                np.load(expanded["port", c]) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype, k
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        stem = np.load(expanded["port", c])["params/ResNet_0/Conv_0/kernel"]
        assert stem.shape[2] == c and (stem[:, :, c - 3:] == 0).all()
    with pytest.raises(ValueError):
        tstraps.expand_regressor_channels(WEIGHTS, expanded["port", 21], 19)


@pytest.fixture(scope="module")
def jax_batches(jassets_):
    """{channels: (JAX's proxy (B, C, 256, 256), the labels its
    synth_crop_batch made, its key)}, both channel counts on one key."""
    rng = jax.random.PRNGKey(25)
    seen = []
    inner = jstraps.synth_crop_batch

    def recording(*a, **kw):
        out = inner(*a, **kw)
        seen.append({k: np.asarray(v) for k, v in out.items()})
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jstraps, "synth_crop_batch", recording)
    try:
        out = {c: (np.asarray(jstraps.synth_regressor_batch(
            jassets_, rng, b=B, wh=WH, proxy_channels=c)["proxy"]
        ).transpose(0, 3, 1, 2), seen[-1], rng) for c in (20, 21)}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("channels", [20, 21])
def test_proxy_of_jax_labels_matches_jax(channels, jax_batches):
    """The proxy assembly (corruption, IUV image, channels) on JAX's own
    labels of the same batch."""
    want, data, rng = jax_batches[channels]
    _, k_corrupt = jax.random.split(rng)
    sil, joints = tstraps.corrupt_proxy_inputs(
        jax_corruption_draws(k_corrupt, B, WH), _t(data["silhouette"]),
        _t(data["joints2d"]))
    iuv = tstraps.gt_iuv_image(_t(data["part"]), _t(data["uv"]), WH,
                               mask=sil)
    got = tstraps._build_proxy(sil, joints, WH, channels, iuv).numpy()
    assert got.shape == (B, channels, 256, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROXY_TOL)
    assert got[:, -3:].max() > 0
    # A cut-out that hits the player zeroes the IUV there too.
    cut = (data["silhouette"] > 0) & (sil.numpy() == 0)
    assert cut.any() and (iuv.numpy()[cut] == 0).all()


@pytest.fixture(scope="module")
def port_batch(assets, jax_batches):
    """The port's own synthesis from JAX's draws, 21 channels (the 20
    channels are the same maps without the silhouette)."""
    rng = jax_batches[21][2]
    return tstraps.synth_regressor_batch(
        assets, jax_regressor_draws(rng, B, WH), wh=WH,
        proxy_channels=21)["proxy"].numpy()


@pytest.mark.parametrize("channels", [20, 21])
def test_synth_regressor_batch_on_jax_draws(channels, jax_batches,
                                            port_batch):
    want = jax_batches[channels][0]
    got = port_batch if channels == 21 else port_batch[:, 1:]
    apart = np.abs(got - want) > PROXY_TOL           # (B, C, 256, 256)
    px = apart.any(1)
    print("%d channels: %d of %d proxy pixels apart (max %.3g)"
          % (channels, int(px.sum()), px.size, np.abs(got - want).max()))
    assert px.mean() <= PX_FRAC
    # Apart only in the silhouette and IUV channels (the labels), never in
    # the heatmaps of the same joints.
    heat = slice(1, 18) if channels == 21 else slice(0, 17)
    assert not apart[:, heat].any()


def test_expanded_21ch_regressor_equals_18ch(expanded):
    rs = np.random.RandomState(3)
    proxy = rs.rand(2, 21, 256, 256).astype(np.float32)
    m18 = convert.load_regressor_weights(WEIGHTS, "cpu")
    m21 = convert.load_regressor_weights(expanded["port", 21], "cpu")
    assert m21.in_channels == 21
    a = synthesize_assets()
    init = default_initial_params(a.mean_pose_rot6d, a.mean_shape)
    with torch.no_grad():
        o18 = m18(_t(proxy[:, :18]), init)
        o21 = m21(_t(proxy), init)
    for x, y in zip(o18, o21):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                   atol=MODEL_TOL)


def test_evaluate_regressor_21ch_matches_jax(expanded, jassets_, assets):
    seed = 10_000_000
    with np.load(expanded["jax", 21]) as z:
        variables = _nest({k: z[k] for k in z.files})
    reg = jreg.SingleInputRegressor(in_channels=21, resnet_layers=18)
    want = jstraps.evaluate_regressor(
        reg, variables["params"], variables["batch_stats"], jassets_,
        n_batches=1, batch=B, wh=WH, seed=seed, proxy_channels=21)
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                              0))[0]
    model = convert.load_regressor_weights(expanded["port", 21], "cpu")
    got = tstraps.evaluate_regressor(
        model, assets, wh=WH, device="cpu",
        draws=[tstraps.RegressorDraws(jax_crop_draws(key, B), None)])
    gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want
            if isinstance(want[k], float)}
    print("21-channel evaluate_regressor relative gaps:", gaps)
    assert len(gaps) == 9 and max(gaps.values()) <= EVAL_REL, gaps
    assert got["n_images"] == want["n_images"] == B
