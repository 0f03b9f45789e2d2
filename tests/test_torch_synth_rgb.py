"""The RGB branch of the port's synthetic crops against the JAX package's
``train/synth.py``, on the draws of the JAX key stream.

:func:`jax_appearance_draws` replays the key splits of
``synth_crop_batch(with_image=True)``: the player's shading and kit from
``keys[1]``/``keys[2]``, the occluder's from ``keys[8]``/``keys[9]``, the
background from ``keys[10]``, the blur from ``keys[11]`` and the
photometric jitter from ``fold_in(keys[11], 1)``; the port gets the very
numbers JAX drew. Three pairs of JAX values come from one uniform each
(a reused key at one shape), and the port derives each pair from one
draw: they are tested here through the colours and backgrounds they make.

Tolerances (B = 2, 64², unless stated):

* kit colours (B = 64, every vertex): ≤ 1e-5 max abs, except at stripe
  flips: a jersey vertex whose stripe test ``sin(freq · coord · 6.28 +
  phase) > 0`` lands the other way, which needs |sin| < 1e-4 (the
  argument, up to ~170, is an fp32 sum that XLA may contract into an FMA;
  one ulp there is 1.5e-5). Flips are counted and printed;
* vertex normals and Lambert shading on JAX's posed bodies: ≤ 1e-5 (the
  scatter-add sums in another order);
* background (domain-randomised and plain), motion blur and photometric
  jitter on identical inputs: ≤ 1e-5, except, in the background, mowing-
  stripe flips, which need |sin| < 1e-4 of the stripes' argument
  (counted, printed);
* the full pass of an identical scene (JAX's own vertices, colours and
  depths, captured inside ``synth_crop_batch``): silhouette and coverage
  exact; colours ≤ 1e-5 except at depth ties, pixels where the two dense
  rasterizers take faces whose depths lie within 8 ulps (XLA contracts
  the barycentric depth sum into FMAs), counted, printed and at most 1%
  of the covered pixels;
* the image composed from JAX's rendered bodies: ≤ 1e-5 max abs, with and
  without domain randomisation; the uint8 crops (``image · 255``
  truncated) differ only where a value lies within 1e-3 of an integer
  (counted, printed);
* without an occluder (one body, plain background; each package on its
  own geometry, 32²): silhouette and image pixels apart (by > 1e-5) at
  ≤ 1% each, boundary pixels where fp32 ulps move an edge and depth ties
  (counted, printed);
* the geometry-only stream is unchanged: the same generator gives the
  same geometry draws, labels and silhouette with and without images.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.smpl.model import (  # noqa: E402
    smpl_forward as j_smpl_forward)
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_synth_eval import jax_crop_draws  # noqa: E402

B, WH = 2, 64
TOL = 1e-5
NEAR_ZERO_SINE = 1e-4
U8_NEAR = 1e-3
# The depths two dense rasterizers choose at a tie may differ by this many
# ulps (XLA contracts the barycentric depth sum into FMAs): the bar of
# chip_smoke.py's k3_parity.
K3_TIE_ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_kit_draws(rng, b):
    """The draws of ``jsynth._kit_vertex_colors(assets, rng, b)``."""
    ks = jax.random.split(rng, 8)
    u = jax.random.uniform
    return tsynth.KitDraws(
        skin_tone=_t(jax.random.randint(ks[0], (b,), 0, 6)).long(),
        skin_gain=_t(u(ks[1], (b, 1), minval=0.85, maxval=1.1)),
        jersey1=_t(u(ks[2], (b, 3), minval=0.05, maxval=1.0)),
        jersey2=_t(u(ks[3], (b, 3), minval=0.05, maxval=1.0)),
        striped=_t(jax.random.randint(ks[4], (b, 1), 0, 2).astype(
            jnp.float32)),
        freq=_t(u(ks[4], (b, 1), minval=8.0, maxval=26.0)),
        stripe_u=_t(u(ks[5], (b, 1))),
        own_shorts=_t(jax.random.bernoulli(ks[6], 0.5, (b, 1))),
        shorts_rgb=_t(u(ks[6], (b, 3), minval=0.05, maxval=1.0)),
        shorts_socks_u=_t(u(ks[7], (b, 1))))


def jax_shading_draws(rng, b):
    k1, k2 = jax.random.split(rng)
    return tsynth.ShadingDraws(
        light=_t(jax.random.normal(k1, (b, 3))),
        ambient=_t(jax.random.uniform(k2, (b, 1, 1), minval=0.45,
                                      maxval=0.75)))


def jax_background_draws(rng, b, h, w):
    """The draws of ``jsynth._background(rng, b, h, w)``."""
    ks = jax.random.split(rng, 10)
    u = jax.random.uniform
    hc, wc = max(h // 4, 1), max(w // 4, 1)
    lines = [jax.random.fold_in(ks[3], i) for i in range(2)]

    def per_line(f):
        return _t(np.stack([np.asarray(f(ka)) for ka in lines]))

    return tsynth.BackgroundDraws(
        base=_t(u(ks[0], (b, 1, 1, 3), minval=-0.08, maxval=0.10)),
        theta=_t(u(ks[1], (b, 1, 1), maxval=3.14)),
        mow_u=_t(u(ks[2], (b, 1, 1))),
        line_alpha=per_line(lambda ka: u(ka, (b, 1, 1), maxval=3.14)),
        line_c=per_line(lambda ka: u(jax.random.fold_in(ka, 1), (b, 1, 1),
                                     maxval=1.0)),
        line_width=per_line(lambda ka: u(jax.random.fold_in(ka, 2),
                                         (b, 1, 1), minval=1.0, maxval=3.0)),
        line_on=per_line(lambda ka: jax.random.bernoulli(
            jax.random.fold_in(ka, 3), 0.6, (b, 1, 1)).astype(jnp.float32)),
        crowd_on=_t(jax.random.bernoulli(ks[4], 0.35, (b, 1, 1)).astype(
            jnp.float32)),
        crowd_frac=_t(u(ks[5], (b, 1, 1), minval=0.10, maxval=0.35)),
        crowd=_t(u(ks[6], (b, hc, wc, 3), minval=0.05, maxval=0.85)),
        wild=_t(jax.random.bernoulli(ks[7], 0.08, (b, 1, 1, 1)).astype(
            jnp.float32)),
        wild_bg=_t(u(ks[8], (b, hc, wc, 3))),
        noise=_t(u(ks[9], (b, h, w, 3), minval=-0.05, maxval=0.05)))


def jax_blur_draws(rng, b):
    k1, k2, k3 = jax.random.split(rng, 3)
    return tsynth.BlurDraws(
        theta=_t(jax.random.uniform(k1, (b,), maxval=3.14)),
        length=_t(jax.random.uniform(k2, (b,), minval=1.0, maxval=9.0)),
        apply=_t(jax.random.bernoulli(k3, 0.35, (b, 1, 1, 1)).astype(
            jnp.float32)))


def jax_photometric_draws(rng, b, h, w):
    ks = jax.random.split(rng, 4)
    u = jax.random.uniform
    return tsynth.PhotometricDraws(
        bright=_t(u(ks[0], (b, 1, 1, 1), minval=-0.10, maxval=0.10)),
        contrast=_t(u(ks[1], (b, 1, 1, 1), minval=0.8, maxval=1.2)),
        gains=_t(u(ks[2], (b, 1, 1, 3), minval=0.92, maxval=1.08)),
        noise=_t(jax.random.normal(ks[3], (b, h, w, 3))),
        noise_scale=_t(u(ks[3], (b, 1, 1, 1), maxval=0.03)))


def jax_appearance_draws(rng, b, wh, domain_rand=True):
    """The appearance draws of ``jsynth.synth_crop_batch(rng, b, wh,
    with_image=True, domain_rand=domain_rand)`` (with occluders)."""
    keys = jax.random.split(rng, 12)
    if domain_rand:
        bg = jax_background_draws(keys[10], b, wh, wh)
        blur = jax_blur_draws(keys[11], b)
        photo = jax_photometric_draws(jax.random.fold_in(keys[11], 1), b,
                                      wh, wh)
    else:
        k1, k2 = jax.random.split(keys[10])
        bg = tsynth.PlainBackgroundDraws(
            base=_t(jax.random.uniform(k1, (b, 1, 1, 3), minval=-0.08,
                                       maxval=0.08)),
            noise=_t(jax.random.uniform(k2, (b, wh, wh, 3), minval=-0.06,
                                        maxval=0.06)))
        blur = photo = None
    return tsynth.AppearanceDraws(
        kit=jax_kit_draws(keys[2], b), shading=jax_shading_draws(keys[1], b),
        occluder_kit=jax_kit_draws(keys[9], b),
        occluder_shading=jax_shading_draws(keys[8], b),
        background=bg, blur=blur, photometric=photo)


def jax_rgb_crop_draws(rng, b, wh, domain_rand=True):
    """All the draws of ``jsynth.synth_crop_batch(rng, b, wh,
    with_image=True)``: geometry and appearance."""
    return jax_crop_draws(rng, b)._replace(
        appearance=jax_appearance_draws(rng, b, wh, domain_rand))


@pytest.fixture(scope="module")
def jassets_():
    return jassets.synthesize_assets()


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


def _stripe_sine(assets, d: tsynth.KitDraws) -> np.ndarray:
    """(B, V) sin of the stripe test's argument, in float64."""
    uvt = tsynth.vertex_uv(assets).double().numpy()
    vertical = d.stripe_u.numpy() < 0.5
    coord = np.where(vertical, uvt[None, :, 0], uvt[None, :, 1])
    freq = (d.striped * d.freq).double().numpy()
    phase = 6.28 * d.stripe_u.double().numpy()
    return np.sin(freq * coord * 6.28 + phase)


def test_kit_colors_match_jax(jassets_, assets):
    key = jax.random.PRNGKey(5)
    b = 64
    want = np.asarray(jsynth._kit_vertex_colors(jassets_, key, b))
    d = jax_kit_draws(key, b)
    got = tsynth._kit_vertex_colors(assets, d).numpy()
    bad = np.abs(got - want).max(-1) > TOL                   # (B, V)
    sine = _stripe_sine(assets, d)
    print("stripe flips: %d of %d vertices" % (bad.sum(), bad.size))
    assert (np.abs(sine[bad]) < NEAR_ZERO_SINE).all(), sine[bad]
    assert bad.sum() <= 0.001 * bad.size
    # The couplings: white shorts come with jersey socks, and both stripe
    # directions and plain kits occur.
    u = d.shorts_socks_u[:, 0].numpy()
    assert ((u < 0.5) & ~d.own_shorts[:, 0].numpy()).any()
    assert (d.stripe_u.numpy() < 0.5).any() and (d.stripe_u.numpy() >= 0.5
                                                 ).any()


def test_normals_and_shading_match_jax(jassets_, assets):
    key = jax.random.PRNGKey(6)
    body, orient, betas, _ = jsynth.random_smpl_params(key, B)
    verts = np.asarray(j_smpl_forward(jassets_, betas, body, orient,
                                      pose2rot=False).vertices)
    faces = np.asarray(jassets_.faces)
    want_n = np.asarray(jsynth._vertex_normals(jnp.asarray(verts),
                                               jnp.asarray(faces)))
    got_n = tsynth._vertex_normals(_t(verts), _t(faces)).numpy()
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=TOL)
    colors = np.random.RandomState(0).rand(B, verts.shape[1], 3).astype(
        np.float32)
    k = jax.random.PRNGKey(7)
    want = np.asarray(jsynth._shaded_colors(k, jnp.asarray(verts),
                                            jnp.asarray(faces),
                                            jnp.asarray(colors)))
    got = tsynth._shaded_colors(jax_shading_draws(k, B), _t(verts), _t(faces),
                                _t(colors)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_background_matches_jax():
    key = jax.random.PRNGKey(8)
    b = 8
    want = np.asarray(jsynth._background(key, b, WH, WH))
    d = jax_background_draws(key, b, WH, WH)
    got = tsynth._background(d, WH, WH).numpy()
    bad = np.abs(got - want).max(-1) > TOL                   # (B, h, w)
    ys, xs = np.mgrid[0:WH, 0:WH].astype(np.float64)
    th = d.theta.double().numpy()
    proj = xs * np.cos(th) + ys * np.sin(th)
    u = d.mow_u.double().numpy()
    sine = np.sin(proj * 6.28 / (25 + 65 * u) + 6.28 * u)
    print("mowing-stripe flips: %d of %d pixels" % (bad.sum(), bad.size))
    assert (np.abs(sine[bad]) < NEAR_ZERO_SINE).all(), sine[bad]
    assert d.line_on.sum() > 0 and d.crowd_on.sum() > 0


def test_plain_background_blur_and_photometric_match_jax():
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    want = np.clip(np.asarray(
        jnp.array([0.18, 0.42, 0.22])
        + jax.random.uniform(k1, (B, 1, 1, 3), minval=-0.08, maxval=0.08)
        + jax.random.uniform(k2, (B, WH, WH, 3), minval=-0.06,
                             maxval=0.06)), 0.0, 1.0)
    d = tsynth.PlainBackgroundDraws(
        base=_t(jax.random.uniform(k1, (B, 1, 1, 3), minval=-0.08,
                                   maxval=0.08)),
        noise=_t(jax.random.uniform(k2, (B, WH, WH, 3), minval=-0.06,
                                    maxval=0.06)))
    np.testing.assert_allclose(tsynth._plain_background(d).numpy(), want,
                               rtol=0, atol=TOL)

    image = np.random.RandomState(1).rand(4, WH, WH, 3).astype(np.float32)
    for seed in range(3):            # until some sample is blurred
        kb = jax.random.PRNGKey(20 + seed)
        blur = jax_blur_draws(kb, 4)
        if blur.apply.sum() > 0:
            break
    assert blur.apply.sum() > 0
    want = np.asarray(jsynth._motion_blur(kb, jnp.asarray(image)))
    got = tsynth._motion_blur(blur, _t(image)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    kp = jax.random.PRNGKey(30)
    want = np.asarray(jsynth._photometric(kp, jnp.asarray(image)))
    got = tsynth._photometric(jax_photometric_draws(kp, 4, WH, WH),
                              _t(image)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def jax_rgb_crops(jassets_, monkeypatch_module):
    """JAX's RGB batches (with and without domain randomisation), the
    full-resolution scene its rasterizer saw and what it returned."""
    seen = {}
    inner = jsynth.rasterize_attributes

    def recording(v2d, z, attrs, faces, img_wh):
        out = inner(v2d, z, attrs, faces, img_wh)
        if img_wh == WH:
            jax.debug.callback(lambda *a: seen.setdefault(
                "pending", [np.asarray(x) for x in a]), v2d, z, attrs, faces,
                *out)
        return out

    monkeypatch_module.setattr(jsynth, "rasterize_attributes", recording)
    out = {}
    for dr in (True, False):
        key = jax.random.PRNGKey(40 + dr)
        batch = jsynth.synth_crop_batch.__wrapped__(
            jassets_, key, b=B, wh=WH, domain_rand=dr, return_params=True)
        out[dr] = (key, {k: np.asarray(v) for k, v in batch.items()},
                   seen.pop("pending"))
    return out, inner


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("domain_rand", [True, False])
def test_image_of_identical_scene_matches_jax(jax_rgb_crops, assets,
                                              domain_rand):
    """On JAX's own scene: the full pass's colours agree but where the two
    dense rasterizers break a depth tie apart (the depths they chose within
    K3_TIE_ULPS), and the image composed from JAX's rendered bodies equals
    JAX's image."""
    crops, oracle = jax_rgb_crops
    key, want, (v2d, z, attrs, faces, j_full, j_mask) = crops[domain_rand]
    # The depth rides along as a last channel, so that where the two take
    # different faces the depth each one chose is read.
    az = np.concatenate([attrs, z[..., None]], -1)
    full, mask = tsynth.rasterize_attributes(_t(v2d), _t(z), _t(az),
                                             _t(faces), WH)
    full, mask = full.numpy(), mask.numpy()
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(
        (mask & (full[..., 3] > 0.5)).astype(np.float32), want["silhouette"])
    apart = np.abs(full[..., :3] - j_full[..., :3]).max(-1) > TOL
    z_port = full[..., -1][apart]
    z_jax = np.asarray(oracle(v2d, z, az, faces, WH)[0])[..., -1][apart]
    gap = np.abs(z_port - z_jax) / _ulp(np.maximum(np.abs(z_port),
                                                   np.abs(z_jax)))
    print("depth-tie pixels: %d of %d covered, gaps %s ulps"
          % (apart.sum(), j_mask.sum(), gap.tolist()))
    assert (gap <= K3_TIE_ULPS).all()
    assert apart.sum() <= 1e-2 * j_mask.sum()

    d = jax_appearance_draws(key, B, WH, domain_rand)
    got = tsynth.compose_image(_t(j_full[..., :3]),
                               _t(j_mask.astype(np.float32)), d).numpy()
    assert want["silhouette"].sum() > 0
    np.testing.assert_allclose(got, want["image"], rtol=0, atol=TOL)
    g8 = (got * 255.0).astype(np.uint8)
    w8 = (want["image"] * 255.0).astype(np.uint8)
    flips = g8 != w8
    frac = want["image"][flips] * 255.0
    print("uint8 flips: %d of %d values" % (flips.sum(), flips.size))
    assert (np.abs(frac - np.round(frac)) < U8_NEAR).all()


def test_scene_colors_of_jax_draws_match_jax(jax_rgb_crops, assets):
    """The port's shaded kit colours from JAX's draws, on its own posed
    bodies, against the colours JAX rasterized: ≤ 1e-5 but at stripe
    flips."""
    key, _, (_, _, attrs, _, _, _) = jax_rgb_crops[0][True]
    draws = jax_rgb_crop_draws(key, B, WH)
    scene = tsynth.crop_scene(assets, draws, WH)
    got = tsynth.scene_colors(assets, scene, draws.appearance).numpy()
    want = attrs[..., :3]
    bad = np.abs(got - want).max(-1) > TOL
    v = assets.v_template.shape[0]
    sine = np.concatenate([_stripe_sine(assets, draws.appearance.kit),
                           _stripe_sine(assets, draws.appearance.occluder_kit)],
                          axis=1)
    print("stripe flips: %d of %d vertices" % (bad.sum(), bad.size))
    assert got.shape == (B, 2 * v, 3)
    assert (np.abs(sine[bad]) < NEAR_ZERO_SINE).all(), sine[bad]


def test_crop_without_occluder_matches_jax(jassets_, assets):
    """``occluders=False`` (one body, plain background), from JAX's draws
    at 32²: each package renders its own scene, so the silhouettes and
    images may differ on boundary pixels, where SMPL's fp32 ulps move an
    edge across a pixel centre, and at depth ties; the pixels apart by
    more than 1e-5 are counted, printed and held to 1% of the image."""
    wh = 32
    key = jax.random.PRNGKey(50)
    want = jsynth.synth_crop_batch.__wrapped__(
        jassets_, key, b=B, wh=wh, occluders=False, domain_rand=False)
    want = {k: np.asarray(v) for k, v in want.items()}
    keys = jax.random.split(key, 12)
    k1, k2 = jax.random.split(keys[10])
    draws = tsynth.CropDraws(
        body=jax_crop_draws(key, B).body, occluder=None,
        appearance=tsynth.AppearanceDraws(
            kit=jax_kit_draws(keys[2], B),
            shading=jax_shading_draws(keys[1], B), occluder_kit=None,
            occluder_shading=None, blur=None, photometric=None,
            background=tsynth.PlainBackgroundDraws(
                base=_t(jax.random.uniform(k1, (B, 1, 1, 3), minval=-0.08,
                                           maxval=0.08)),
                noise=_t(jax.random.uniform(k2, (B, wh, wh, 3),
                                            minval=-0.06, maxval=0.06)))))
    got = {k: v.numpy() for k, v in tsynth.render_crop_batch(
        assets, draws, wh, with_image=True).items()}
    sil_apart = got["silhouette"] != want["silhouette"]
    px_apart = np.abs(got["image"] - want["image"]).max(-1) > TOL
    print("no occluder: silhouette pixels apart %d, image pixels apart %d "
          "of %d" % (sil_apart.sum(), px_apart.sum(), sil_apart.size))
    assert want["silhouette"].sum() > 0
    assert sil_apart.mean() <= 0.01 and px_apart.mean() <= 0.01


def test_geometry_stream_is_unchanged_by_images(assets):
    wh = 32
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    plain = tsynth.sample_crop_draws(g1, B)
    rgb = tsynth.sample_crop_draws(g2, B, image_wh=wh)
    assert plain.appearance is None and rgb.appearance is not None
    for a, b in zip(jax.tree_util.tree_leaves(tuple(plain[:2])),
                    jax.tree_util.tree_leaves(tuple(rgb[:2]))):
        assert torch.equal(a, b)
    labels = tsynth.render_crop_batch(assets, plain, wh)
    with_image = tsynth.render_crop_batch(assets, rgb, wh, with_image=True)
    for k, v in labels.items():
        assert torch.equal(v, with_image[k]), k
    img = with_image["image"]
    assert img.shape == (B, wh, wh, 3)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    with pytest.raises(ValueError, match="appearance"):
        tsynth.render_crop_batch(assets, plain, wh, with_image=True)
    with pytest.raises(ValueError, match="appearance"):
        tsynth.render_crop_batch(assets, rgb, 2 * wh, with_image=True)
