"""The port's scene factory (``train/scenes.py``) against the JAX package's,
on the draws of the JAX key stream.

:func:`jax_scene_views_draws` and :func:`jax_track_draws` replay the key
splits of ``synth_scene_views`` and ``synth_track_views``, including the
two draws JAX turns into host floats (each narrow view's azimuth noise and
the broad azimuth); the port gets the very numbers JAX drew.

The port renders through K3's PyTorch mirror
(``test_torch_extract.fast_rasterize_attributes``), JAX through its dense
oracle; both record the scene they rasterized, with the depth as a last
attribute channel. Tolerances (N = 2 players, 64²):

* scene parameters, ``orient_for_view`` and the track's parameters from
  the same draws: ≤ 1e-5 max abs (boxes, in 1920 × 1080 frame pixels,
  ≤ 1e-5 relative); azimuths equal;
* joints ≤ 1e-3 px (the two SMPL forwards place vertices within ~1e-5 px
  at 64², tests/test_torch_synth_eval.py);
* silhouettes and rendered colours: a pixel covered on one side only, or
  whose colour differs by more than 1e-5, must be an edge pixel (its
  centre within ``EDGE_PX`` of an edge of one of JAX's projected faces) or
  a depth tie (the depths chosen within ``K3_TIE_ULPS``), counted, printed
  and at most 1% of the covered pixels (the rule of
  tests/test_torch_synth_frame.py);
* the images: apart (by > 1e-5) only within the motion blur's reach of
  such a pixel; composed from JAX's own rendered bodies ≤ 1e-5;
* ``_linspace01`` equals ``jnp.linspace(0, 1, t)`` bit for bit (torch's
  ``linspace`` rounds some interior points the other way).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import scenes as jscenes  # noqa: E402

from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import scenes as tscenes  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import fast_rasterize_attributes  # noqa: E402
from test_torch_synth_frame import _edge_distance  # noqa: E402
from test_torch_synth_rgb import (  # noqa: E402
    K3_TIE_ULPS, jax_background_draws, jax_blur_draws, jax_kit_draws,
    jax_photometric_draws, jax_shading_draws)

N, V, T, WH = 2, 2, 3, 64
TOL = 1e-5
J2D_TOL = 1e-3
PX_FRAC = 1e-2
EDGE_PX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The JAX key stream's draws
# ---------------------------------------------------------------------------

def jax_scene_draws(rng, n):
    """The draws of ``jscenes.synth_scene_params(rng, n)``."""
    ks = jax.random.split(rng, 8)
    u, g = jax.random.uniform, jax.random.normal
    return tscenes.SceneDraws(
        base_noise=_t(g(ks[0], (1, 23, 3))),
        base_energy=_t(u(ks[1], (1, 1, 1), minval=0.4, maxval=1.5)),
        indiv_noise=_t(g(ks[2], (n, 23, 3))),
        indiv_energy=_t(u(ks[3], (n, 1, 1), minval=0.4, maxval=1.5)),
        shape_noise=_t(g(ks[4], (n, 10))),
        pitch_xy=_t(u(ks[5], (n, 2), minval=0.05, maxval=0.95)),
        ball_xy=_t(u(ks[6], (2,), minval=0.15, maxval=0.85)),
        yaw_noise=_t(g(ks[7], (n,))))


def jax_orient_draws(rng, n):
    """The draws of ``jscenes.orient_for_view(rng, yaw (n,), azimuth)``."""
    k1, k2 = jax.random.split(rng)
    return tscenes.OrientDraws(tilt=_t(jax.random.normal(k1, (n, 1))),
                               sway=_t(jax.random.normal(k2, (n, 2))))


def jax_render_view_appearance(rng, n, wh):
    """The appearance draws of ``jscenes.render_view(rng, ...,
    with_image=True)`` for n wh² crops."""
    keys = jax.random.split(rng, 4)
    return tsynth.AppearanceDraws(
        kit=jax_kit_draws(keys[1], n), shading=jax_shading_draws(keys[0], n),
        occluder_kit=None, occluder_shading=None,
        background=jax_background_draws(keys[2], n, wh, wh),
        blur=jax_blur_draws(keys[3], n),
        photometric=jax_photometric_draws(jax.random.fold_in(keys[3], 1), n,
                                          wh, wh))


def jax_view_draws(kv, n, lo, hi, wh=None):
    """The draws of ``synth_scene_views``' ``one_view(kv, ...)``."""
    k1, k2, k3 = jax.random.split(kv, 3)
    u = jax.random.uniform
    appearance = None
    if wh is not None:
        appearance = jax_render_view_appearance(jax.random.fold_in(kv, 7),
                                                n, wh)
    return tscenes.ViewDraws(
        orient=jax_orient_draws(k1, n),
        scale=_t(u(k2, (n,), minval=lo, maxval=hi)),
        offset=_t(u(k3, (n, 2), minval=-0.15, maxval=0.15)),
        appearance=appearance)


def jax_scene_views_draws(rng, n, n_views, wh=None, broad=True):
    """The draws of ``jscenes.synth_scene_views(rng, n, n_views,
    with_image=wh is not None, broad=broad)``."""
    k_scene, k_views = jax.random.split(rng)
    kvs = [jax.random.fold_in(k_views, v) for v in range(n_views)]
    az_noise = _t(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kv, 1), ())) for kv in kvs]))
    views = tuple(jax_view_draws(kv, n, *tscenes.NARROW_SCALE, wh)
                  for kv in kvs)
    broad_az = bview = None
    if broad:
        kb = jax.random.fold_in(k_views, 1000)
        broad_az = _t(jax.random.uniform(jax.random.fold_in(kb, 1), (),
                                         minval=-np.pi, maxval=np.pi))
        bview = jax_view_draws(kb, n, *tscenes.BROAD_SCALE, wh)
    return tscenes.SceneViewsDraws(jax_scene_draws(k_scene, n), az_noise,
                                   views, broad_az, bview)


def jax_track_draws(rng, n, t, wh=None):
    """The draws of ``jscenes.synth_track_views(rng, n, t,
    with_image=wh is not None)``."""
    ks = jax.random.split(rng, 10)
    u, g = jax.random.uniform, jax.random.normal
    return tscenes.TrackDraws(
        pose_noise=_t(np.stack([g(k, (n, 23, 3)) for k in ks[:2]])),
        energy=_t(np.stack([u(jax.random.fold_in(k, 1), (n, 1, 1),
                              minval=0.4, maxval=1.5) for k in ks[:2]])),
        yaw0=_t(u(ks[2], (n,), minval=-np.pi, maxval=np.pi)),
        dyaw=_t(g(ks[3], (n,))),
        orient=jax_orient_draws(ks[4], n * t),
        shape_noise=_t(g(ks[5], (n, 10))),
        scale=_t(u(ks[6], (n, 1), minval=0.6, maxval=0.95)),
        scale_noise=_t(g(ks[7], (n, t))),
        txy=_t(g(ks[8], (n, t, 2))),
        appearance=(None if wh is None else
                    jax_render_view_appearance(ks[9], n * t, wh)))


# ---------------------------------------------------------------------------
# Recorded renders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def jassets_():
    return jassets.synthesize_assets()


def run_jax_recorded(fn):
    """``fn()`` with JAX's view renders recorded: a list of (v2d, z,
    attrs, faces, out, mask) per rasterizer pass, the depth as out's last
    channel. ``render_view`` is jitted afresh, from a new copy of its
    function (jit caches traces by function), so no earlier trace skips
    the recording."""
    seen = []
    f = jscenes.render_view.__wrapped__
    fresh = types.FunctionType(f.__code__, f.__globals__, f.__name__,
                               f.__defaults__, f.__closure__)
    fresh.__kwdefaults__ = f.__kwdefaults__
    inner = jscenes.rasterize_attributes

    def recording(v2d, z, attrs, faces, img_wh):
        az = jnp.concatenate([attrs, z[..., None]], axis=-1)
        out, mask = inner(v2d, z, az, faces, img_wh)
        jax.debug.callback(lambda *a: seen.append([np.asarray(x) for x in a]),
                           v2d, z, attrs, faces, out, mask)
        return out[..., :-1], mask

    mp = pytest.MonkeyPatch()
    mp.setattr(jscenes, "rasterize_attributes", recording)
    mp.setattr(jscenes, "render_view", jax.jit(
        fresh, static_argnames=("wh", "with_image")))
    try:
        out = fn()
        jax.effects_barrier()
    finally:
        mp.undo()
    return out, seen


def run_port_recorded(fn):
    """``fn()`` with the port's view renders going through K3's mirror,
    recorded as (out, mask) per pass, the depth as out's last channel."""
    seen = []

    def recording(v2d, z, attrs, faces, img_wh):
        az = torch.cat([attrs, z[..., None]], dim=-1)
        out, mask = fast_rasterize_attributes(v2d, z, az, faces, img_wh)
        seen.append((out.numpy(), mask.numpy()))
        return out[..., :-1], mask

    mp = pytest.MonkeyPatch()
    mp.setattr(tscenes, "rasterize_attributes", recording)
    try:
        out = fn()
    finally:
        mp.undo()
    return out, seen


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


def assert_renders_agree(j_pass, p_pass, colors: bool):
    """One rasterizer pass of each side: pixels apart (coverage, or colour
    when ``colors``) only at edges or depth ties, at most PX_FRAC of the
    covered pixels. Returns the (b, y, x) of the pixels apart."""
    v2d, _, _, faces, j_full, j_mask = j_pass
    p_full, p_mask = p_pass
    apart = p_mask != j_mask
    if colors:
        apart |= (p_mask & j_mask) & (np.abs(
            p_full[..., :-1] - j_full[..., :-1]).max(-1) > TOL)
    idx = np.argwhere(apart)
    z_p, z_j = p_full[..., -1][apart], j_full[..., -1][apart]
    tie = (np.abs(z_p - z_j) / _ulp(np.maximum(np.abs(z_p), np.abs(z_j)))
           <= K3_TIE_ULPS) & p_mask[apart] & j_mask[apart]
    edge = np.array([
        _edge_distance(v2d[bi][faces], np.array([[x, y]], np.float32))[0]
        for bi, y, x in idx]).reshape(-1)
    print("pixels apart: %d of %d covered (%d depth ties), edge distances "
          "%s px" % (len(idx), j_mask.sum(), tie.sum(), edge.tolist()))
    assert j_mask.sum() > 0
    assert (tie | (edge <= EDGE_PX)).all()
    assert len(idx) <= PX_FRAC * j_mask.sum()
    return idx


def assert_images_agree(got, want, idx):
    """Images apart (by > TOL) only within the blur's reach of a rendered
    pixel apart."""
    img_apart = np.abs(got - want).max(-1) > TOL
    r = tsynth.BLUR_KSIZE // 2
    reach = np.zeros_like(img_apart)
    for bi, y, x in idx:
        reach[bi, max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1] = True
    print("image pixels apart: %d" % img_apart.sum())
    assert not (img_apart & ~reach).any()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_scene_params_match_jax():
    key = jax.random.PRNGKey(3)
    want = jscenes.synth_scene_params(key, 5)
    got = tscenes.synth_scene_params(jax_scene_draws(key, 5))
    assert set(got) == set(want)
    for k in ("body_pose", "betas", "yaw", "pitch_xy", "ball_xy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=TOL, atol=0)
    # The knees flex one way.
    aa = np.asarray(want["body_pose"])
    assert aa.shape == (5, 23, 3, 3)


@pytest.mark.parametrize("azimuth", [0.0, 2.0943951023931953, -2.5])
def test_orient_for_view_matches_jax(azimuth):
    key = jax.random.PRNGKey(4)
    yaw = np.random.RandomState(0).uniform(-3, 3, 7).astype(np.float32)
    want = jscenes.orient_for_view(key, jnp.asarray(yaw), azimuth)
    got = tscenes.orient_for_view(jax_orient_draws(key, 7), _t(yaw), azimuth)
    assert got.shape == (7, 1, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("t", list(range(1, 41)))
def test_linspace_matches_jnp(t):
    np.testing.assert_array_equal(tscenes._linspace01(t, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0, 1, t)))


@pytest.mark.parametrize("with_image", [False, True])
def test_scene_views_match_jax(jassets_, assets, with_image):
    key = jax.random.PRNGKey(21)
    wh = WH if with_image else None
    want, j_seen = run_jax_recorded(lambda: jscenes.synth_scene_views(
        jassets_, key, n_players=N, n_views=V, wh=WH, with_image=with_image,
        broad=True))
    got, p_seen = run_port_recorded(lambda: tscenes.synth_scene_views(
        assets, jax_scene_views_draws(key, N, V, wh, broad=True), wh=WH))
    for k in ("body_pose", "betas", "yaw", "pitch_xy", "ball_xy"):
        np.testing.assert_allclose(got["scene"][k].numpy(),
                                   np.asarray(want["scene"][k]), rtol=0,
                                   atol=TOL, err_msg=k)
    views = list(zip(want["views"] + [want["broad"]],
                     got["views"] + [got["broad"]]))
    assert len(j_seen) == len(p_seen) == len(views) == V + 1
    for (wv, gv), j_pass, p_pass in zip(views, j_seen, p_seen):
        assert gv["azimuth"] == wv["azimuth"]
        for k in ("global_orient", "cam_wp"):
            np.testing.assert_allclose(gv[k].numpy(), np.asarray(wv[k]),
                                       rtol=0, atol=TOL, err_msg=k)
        np.testing.assert_allclose(gv["joints2d"].numpy(),
                                   np.asarray(wv["joints2d"]), rtol=0,
                                   atol=J2D_TOL)
        idx = assert_renders_agree(j_pass, p_pass, colors=with_image)
        np.testing.assert_array_equal(gv["silhouette"].numpy() > 0.5,
                                      p_pass[1])
        assert ("image" in gv) == ("image" in wv) == with_image
        if with_image:
            assert gv["image"].shape == (N, WH, WH, 3)
            assert_images_agree(gv["image"].numpy(), np.asarray(wv["image"]),
                                idx)


def test_view_image_composed_from_jax_bodies(jassets_):
    """The image of one view composed from JAX's own rendered bodies and
    the port's appearance draws: ≤ 1e-5."""
    key = jax.random.PRNGKey(22)
    want, j_seen = run_jax_recorded(lambda: jscenes.synth_scene_views(
        jassets_, key, n_players=N, n_views=1, wh=WH, with_image=True,
        broad=False))
    d = jax_scene_views_draws(key, N, 1, WH, broad=False).views[0]
    _, _, _, _, j_full, j_mask = j_seen[0]
    got = tsynth.compose_image(_t(j_full[..., :3]),
                               _t(j_mask.astype(np.float32)), d.appearance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["views"][0][
        "image"]), rtol=0, atol=TOL)


@pytest.mark.parametrize("with_image", [False, True])
def test_track_views_match_jax(jassets_, assets, with_image):
    key = jax.random.PRNGKey(23)
    wh = WH if with_image else None
    want, j_seen = run_jax_recorded(lambda: jscenes.synth_track_views(
        jassets_, key, n_players=N, n_frames=T, wh=WH,
        with_image=with_image))
    got, p_seen = run_port_recorded(lambda: tscenes.synth_track_views(
        assets, jax_track_draws(key, N, T, wh), wh=WH))
    shapes = {"silhouette": (N, T, WH, WH), "joints2d": (N, T, 17, 2),
              "body_pose": (N, T, 23, 3, 3), "global_orient": (N, T, 1, 3, 3),
              "betas": (N, 10), "cam_wp": (N, T, 3)}
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape, k
    for k in ("body_pose", "global_orient", "betas", "cam_wp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got["joints2d"].numpy(),
                               np.asarray(want["joints2d"]), rtol=0,
                               atol=J2D_TOL)
    assert len(j_seen) == len(p_seen) == 1           # one pass for N·T crops
    idx = assert_renders_agree(j_seen[0], p_seen[0], colors=with_image)
    assert ("image" in got) == ("image" in want) == with_image
    if with_image:
        assert_images_agree(got["image"].numpy().reshape(N * T, WH, WH, 3),
                            np.asarray(want["image"]).reshape(
                                N * T, WH, WH, 3), idx)


def test_sampled_scenes_render_on_cpu(assets):
    """The port's own samplers: shapes, ranges, and the geometry stream is
    the same with and without images."""
    d0 = tscenes.sample_scene_views_draws(torch.Generator().manual_seed(0),
                                          3, 2)
    d1 = tscenes.sample_scene_views_draws(torch.Generator().manual_seed(0),
                                          3, 2, image_wh=16)
    for a, b in zip(d0.scene, d1.scene):
        assert torch.equal(a, b)
    assert torch.equal(d0.broad.scale, d1.broad.scale)
    assert d0.views[0].appearance is None
    assert d1.views[1].appearance.background.noise.shape == (3, 16, 16, 3)
    for vd in d0.views:
        assert bool(((vd.scale >= 0.65) & (vd.scale < 1.0)).all())
    assert bool(((d0.broad.scale >= 0.55) & (d0.broad.scale < 0.85)).all())
    out = tscenes.synth_scene_views(assets, d1, wh=16)
    assert len(out["views"]) == 2 and "broad" in out
    assert out["broad"]["image"].shape == (3, 16, 16, 3)
    assert float(out["views"][0]["silhouette"].sum()) > 0
    td = tscenes.sample_track_draws(torch.Generator().manual_seed(1), 2, 4)
    tr = tscenes.synth_track_views(assets, td, wh=16)
    assert tr["silhouette"].shape == (2, 4, 16, 16)
    assert "image" not in tr
    assert float(tr["silhouette"].sum()) > 0
