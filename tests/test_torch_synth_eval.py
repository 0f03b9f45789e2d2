"""The port's synthetic crops and held-out regressor evaluation against the
JAX package, on the draws of the JAX key stream.

The JAX ``synth_crop_batch`` splits its key into ``keys[0..11]``; the
geometry branch draws from ``keys[0]`` (the player), ``keys[3]`` (the
occluder's body) and ``keys[4..7]`` (side, offset, depth offset, presence).
:func:`jax_crop_draws` replays those splits here and hands the port the
very numbers JAX drew.

* ``smpl_params_from_draws`` vs ``random_smpl_params``: ≤ 1e-5 max abs;
* the depth-offset coupling: sign and magnitude from one uniform, as
  JAX's ``bernoulli``/``uniform`` pair on one key: signs equal, magnitudes
  within 1 ulp (XLA's CPU backend fuses u·(hi − lo) + lo into an FMA);
* the labels of a scene with identical vertices (JAX's own, taken from
  inside ``synth_crop_batch``): silhouette, part and joint visibility
  exact, uv ≤ 1e-6 max abs (the barycentric sum of three products rounds
  in another order in XLA's dot);
* end to end from the same draws at b=2, wh=64: SMPL vertices differ by
  fp32 ulps between the frameworks (ROADMAP "Faults"), so ≤ 0.1% of the
  silhouette pixels may differ (all on a boundary), ≤ 1% of the stride-4
  part pixels; parameters ≤ 1e-5, joints ≤ 1e-3 px;
* the regressor metrics on JAX's own silhouette and joints: ≤ 1e-4
  relative;
* ``evaluate_regressor(n_batches=1, batch=2, wh=64)``: ≤ 1e-3 relative per
  metric (the test prints the measured gap);
* ``corrupt_proxy_inputs`` on JAX's draws: exact.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import regressor as jreg  # noqa: E402
from soccerplayershapepose_tpu.models.ief import (  # noqa: E402
    default_initial_params as j_init)
from soccerplayershapepose_tpu.pipeline import proxy as jproxy  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.ief import (  # noqa: E402
    default_initial_params)
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
B, WH = 2, 64
SEED = 10_000_000          # evaluate_regressor's default seed
PARAM_TOL = 1e-5
UV_TOL = 1e-6
SIL_FRAC = 1e-3
PART_FRAC = 1e-2
METRIC_REL = 1e-4
EVAL_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_body_draws(rng, b, yaw_range=np.pi):
    """The draws of ``jsynth.random_smpl_params(rng, b)``."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(rng, 6)
    u = jax.random.uniform
    cam = jnp.stack([u(k4, (b,), minval=0.5, maxval=1.1),
                     u(jax.random.fold_in(k4, 1), (b,), minval=-0.2,
                       maxval=0.2),
                     u(jax.random.fold_in(k4, 2), (b,), minval=-0.2,
                       maxval=0.2)], axis=-1)
    return tsynth.BodyDraws(
        pose_noise=_t(jax.random.normal(k1, (b, 23, 3))),
        energy=_t(u(k5, (b, 1, 1), minval=0.4, maxval=1.5)),
        tilt=_t(jax.random.normal(k2, (b, 1))),
        sway=_t(jax.random.normal(k2, (b, 2))),
        yaw=_t(u(k6, (b,), minval=-yaw_range, maxval=yaw_range)),
        shape_noise=_t(jax.random.normal(k3, (b, 10))),
        cam_wp=_t(cam))


def jax_crop_draws(rng, b):
    """The draws of ``jsynth.synth_crop_batch(rng, b, with_image=False)``."""
    keys = jax.random.split(rng, 12)
    occ = tsynth.OccluderDraws(
        body=jax_body_draws(keys[3], b),
        side=_t(jnp.where(jax.random.bernoulli(keys[4], 0.5, (b,)), 1.0,
                          -1.0)),
        offset=_t(jax.random.uniform(keys[5], (b,), minval=0.35,
                                     maxval=0.8)),
        dz_u=_t(jax.random.uniform(keys[6], (b,))),
        present=_t(jax.random.bernoulli(keys[7], 0.45, (b, 1)).astype(
            jnp.float32)))
    return tsynth.CropDraws(jax_body_draws(keys[0], b), occ)


def _nest(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.asarray(arr, np.float32))
    return out


@pytest.fixture(scope="module")
def jassets_():
    return jassets.synthesize_assets()


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def jax_variables():
    with np.load(WEIGHTS) as z:
        return _nest({k: z[k] for k in z.files})


@pytest.fixture(scope="module")
def eval_key():
    """The synth key of evaluate_regressor's first batch."""
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED),
                                               0))[0]


@pytest.fixture(scope="module")
def jax_crop(jassets_, eval_key, monkeypatch_module):
    """JAX's synth batch, with the scenes its two rasterizer passes saw
    (captured by a host callback around ``rasterize_attributes``)."""
    seen = {}
    inner = jsynth.rasterize_attributes

    def recording(v2d, z, attrs, faces, img_wh):
        jax.debug.callback(
            lambda *a: seen.setdefault(img_wh, [np.asarray(x) for x in a]),
            v2d, z, attrs, faces)
        return inner(v2d, z, attrs, faces, img_wh)

    monkeypatch_module.setattr(jsynth, "rasterize_attributes", recording)
    out = jsynth.synth_crop_batch.__wrapped__(
        jassets_, eval_key, b=B, wh=WH, with_image=False, return_params=True)
    out = {k: np.asarray(v) for k, v in out.items()}
    return out, seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_crop(assets, eval_key):
    return {k: v.numpy() for k, v in tsynth.render_crop_batch(
        assets, jax_crop_draws(eval_key, B), WH, return_params=True).items()}


def test_smpl_params_from_jax_draws(jassets_):
    key = jax.random.PRNGKey(7)
    want = jsynth.random_smpl_params(key, 4)
    got = tsynth.smpl_params_from_draws(jax_body_draws(key, 4))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_TOL)


def test_dz_coupling():
    """Sign and size of the occluder's depth offset come from one uniform:
    nearer by [0.3, 0.75), farther by [0.75, 1.2), as JAX's key reuse
    makes them."""
    key = jax.random.split(jax.random.PRNGKey(3), 12)[6]
    n = 4096
    want = np.asarray(
        jnp.where(jax.random.bernoulli(key, 0.5, (n,)), -1.0, 1.0)
        * jax.random.uniform(key, (n,), minval=0.3, maxval=1.2))
    got = tsynth.occluder_depth_offset(
        _t(jax.random.uniform(key, (n,)))).numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    near, far = got[got < 0], got[got > 0]
    assert near.size and far.size
    assert -near.max() >= 0.3 and -near.min() < 0.75
    assert far.min() >= 0.75 and far.max() < 1.2
    u = tsynth.sample_crop_draws(torch.Generator().manual_seed(0),
                                 n).occluder.dz_u
    dz = tsynth.occluder_depth_offset(u)
    assert torch.equal(dz < 0, torch.abs(dz) < 0.75)


def test_labels_of_identical_scene_are_exact(jax_crop, assets):
    out, seen = jax_crop
    v2d, z, attrs, faces = seen[WH]
    got = tsynth.crop_labels(assets, _t(v2d), _t(z), _t(faces),
                             _t(attrs[..., 3:4]), _t(out["joints2d"]), WH)
    assert out["silhouette"].sum() > 0 and (out["part"] > 0).any()
    for k in ("silhouette", "part", "kp_visible"):
        np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
    np.testing.assert_allclose(got["uv"].numpy(), out["uv"], rtol=0,
                               atol=UV_TOL)


def test_scene_of_jax_draws_matches_jax(jax_crop, assets, eval_key):
    """The port's scene from JAX's draws against the scene JAX rasterized."""
    _, seen = jax_crop
    scene = tsynth.crop_scene(assets, jax_crop_draws(eval_key, B), WH)
    v2d, z, attrs, faces = seen[WH]
    np.testing.assert_array_equal(scene["faces"].numpy(), faces)
    np.testing.assert_array_equal(scene["is_player"].numpy(),
                                  attrs[..., 3:4])
    near = np.abs(v2d) < 1e4                # present bodies; absent at +1e5
    np.testing.assert_array_equal(np.abs(scene["verts2d"].numpy()) < 1e4,
                                  near)
    np.testing.assert_allclose(scene["verts2d"].numpy()[near], v2d[near],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(scene["verts_z"].numpy(), z, rtol=1e-5)


def test_render_crop_batch_matches_jax(jax_crop, port_crop):
    want, _ = jax_crop
    got = port_crop
    for k in ("body_pose", "global_orient", "betas", "cam_wp"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=1e-3)
    sil_diff = np.mean(got["silhouette"] != want["silhouette"])
    part_diff = np.mean(got["part"] != want["part"])
    print("differing pixels: silhouette %.3g, part %.3g"
          % (sil_diff, part_diff))
    assert want["silhouette"].sum() > 0
    assert sil_diff <= SIL_FRAC and part_diff <= PART_FRAC
    np.testing.assert_array_equal(got["kp_visible"], want["kp_visible"])


def test_regressor_metrics_on_jax_inputs(jax_crop, jassets_, jax_variables,
                                         assets):
    """Proxy → regressor → metrics of both packages on JAX's own
    silhouette, joints and targets."""
    data, _ = jax_crop
    reg = jreg.SingleInputRegressor(in_channels=18, resnet_layers=18)
    scale = 512.0 / WH

    def jax_cell(v, a, sil, j2d, pose, betas):
        proxy = jproxy.create_proxy_representation(sil, j2d, in_wh=WH)
        init = j_init(a.mean_pose_rot6d, a.mean_shape)
        cam, pose6d, shape = reg.apply(v, proxy, init)
        return jstraps.regressor_metrics(a, cam, pose6d, shape, pose, betas,
                                         j2d * scale)

    target_pose = np.concatenate([data["global_orient"], data["body_pose"]],
                                 axis=1)
    want = jax.jit(jax_cell)(jax_variables, jassets_, data["silhouette"],
                             data["joints2d"], target_pose, data["betas"])
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    with torch.no_grad():
        proxy = tstraps._build_proxy(_t(data["silhouette"]),
                                     _t(data["joints2d"]), WH, 18)
        cam, pose6d, shape = model(proxy, default_initial_params(
            assets.mean_pose_rot6d, assets.mean_shape))
        got = tstraps.regressor_metrics(
            assets, cam, pose6d, shape, _t(target_pose), _t(data["betas"]),
            _t(data["joints2d"] * scale))
    assert set(got) == set(want)
    for k in got:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= METRIC_REL * abs(w), (k, got[k], w)


def test_evaluate_regressor_matches_jax(jassets_, jax_variables, assets,
                                        eval_key):
    reg = jreg.SingleInputRegressor(in_channels=18, resnet_layers=18)
    want = jstraps.evaluate_regressor(
        reg, jax_variables["params"], jax_variables["batch_stats"], jassets_,
        n_batches=1, batch=B, wh=WH)
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    got = tstraps.evaluate_regressor(
        model, assets, n_batches=1, batch=B, wh=WH, device="cpu",
        draws=[tstraps.RegressorDraws(jax_crop_draws(eval_key, B), None)])
    for k in ("n_images", "eval_wh", "corrupt_eval"):
        assert got[k] == want[k], k
    gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want
            if isinstance(want[k], float)}
    print("evaluate_regressor relative gap per metric:", gaps)
    assert len(gaps) == 9 and max(gaps.values()) <= EVAL_REL, gaps


def test_corrupt_proxy_inputs_on_jax_draws():
    rng = jax.random.PRNGKey(11)
    b, wh = 3, 64
    sil = np.ones((b, wh, wh), np.float32)
    j2d = np.random.RandomState(0).uniform(0, wh, (b, 17, 2)).astype(
        np.float32)
    want = jstraps.corrupt_proxy_inputs(rng, jnp.asarray(sil),
                                        jnp.asarray(j2d), return_scores=True)
    k_jit, k_drop, k_cut, k_score = jax.random.split(rng, 4)
    cuts = [jax.random.split(jax.random.fold_in(k_cut, c), 3)
            for c in range(2)]
    u = jax.random.uniform
    draws = tstraps.CorruptionDraws(
        jitter=_t(jax.random.normal(k_jit, (b, 17, 2))),
        dropped=_t(jax.random.bernoulli(k_drop, 0.08, (b, 17))),
        score_noise=_t(jax.random.normal(k_score, (b, 17))),
        cut_active=_t(np.stack([np.asarray(jax.random.bernoulli(
            k1, 0.5, (b, 1, 1)))[:, 0, 0] for k1, _, _ in cuts])),
        cut_centre=_t(np.stack([u(k2, (b, 2), minval=0.0, maxval=wh)
                                for _, k2, _ in cuts])),
        cut_half=_t(np.stack([u(k3, (b, 2), minval=0.03 * wh,
                                maxval=0.5 * 0.35 * wh)
                              for _, _, k3 in cuts])))
    got = tstraps.corrupt_proxy_inputs(draws, _t(sil), _t(j2d),
                                       return_scores=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    assert (got[0].numpy() == 0).any()


def test_sampled_draws_render_on_cpu(assets):
    """The port's own sampler: shapes, value ranges, a visible player."""
    gen = torch.Generator().manual_seed(0)
    d = tstraps.sample_regressor_draws(gen, 2, 32, corrupt=True)
    batch = tstraps.synth_regressor_batch(assets, d, wh=32)
    assert batch["proxy"].shape == (2, 18, 256, 256)
    assert batch["target_pose"].shape == (2, 24, 3, 3)
    assert float(batch["proxy"][:, 0].sum()) > 0
    c = d.crop.body.cam_wp
    assert bool(((c[:, 0] >= 0.5) & (c[:, 0] < 1.1)).all())
