"""The port's relation module and its held-out evaluation against the JAX
package, with the committed weights and on the draws of the JAX key
stream.

* ``bbox_positional_embedding``: XLA's and torch's fp32 ``log`` differ by
  up to one ulp, and the embedding takes sin/cos of 100× the log terms,
  so each entry is held to 1e-6 relative to its sine's argument
  (|gap| ≤ 1e-6 · (1 + |angle|)); the module downstream absorbs it;
* v0 and v1 ``PoseRelationModule`` from ``weights/relation_v{0,1}.npz``
  against flax on identical rotmats and boxes with padded slots: ≤ 1e-5
  max abs; padded players pass through bit for bit;
* ``synth_relation_batch`` on JAX's draws: ≤ 1e-6 max abs on the rotmats
  (≤ 1e-6 relative on the 1920 × 1080 frame boxes), the mask equal;
* ``evaluate_relation`` on one identical batch: ≤ 1e-5 relative per
  metric.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import relation as jrel  # noqa: E402
from soccerplayershapepose_tpu.ops.rotations import (  # noqa: E402
    batch_rodrigues as j_rodrigues)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import relation as jtrain  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models import relation as trel  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import relation as ttrain  # noqa: E402

from test_torch_scenes import (  # noqa: E402
    jax_orient_draws, jax_scene_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = {v: os.path.join(REPO, "weights", "relation_v%d.npz" % v)
           for v in (0, 1)}
KWARGS = {0: {}, 1: jtrain.V1_KWARGS}
B, N = 2, 5
EMBED_REL = 1e-6
MODULE_TOL = 1e-5
BATCH_TOL = 1e-6
METRIC_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_relation_draws(rng, b, n):
    """The draws of ``jtrain.synth_relation_batch(rng, b, n)``."""
    ks = jax.random.split(rng, 6)
    u, g = jax.random.uniform, jax.random.normal
    orients = [jax_orient_draws(k, n) for k in jax.random.split(ks[2], b)]
    return ttrain.RelationDraws(
        scenes=tuple(jax_scene_draws(k, n)
                     for k in jax.random.split(ks[0], b)),
        azimuth=_t(u(ks[1], (b,), minval=-np.pi, maxval=np.pi)),
        orient=type(orients[0])(*(torch.cat(x) for x in zip(*orients))),
        sigma=_t(u(ks[3], (b, 1, 1, 1), minval=ttrain.NOISE_LO,
                   maxval=ttrain.NOISE_HI)),
        eps=_t(g(ks[4], (b, n, 24, 3))),
        outlier=_t(jax.random.bernoulli(ks[5], ttrain.OUTLIER_P,
                                        (b, n, 24, 1))),
        outlier_eps=_t(g(jax.random.fold_in(ks[5], 1), (b, n, 24, 3))),
        n_real=_t(jax.random.randint(jax.random.fold_in(ks[5], 2), (b,), 2,
                                     n + 1)).to(torch.int64))


def random_frame(seed=0):
    """B frames of N players: rotmats, boxes and a mask with padding."""
    rs = np.random.RandomState(seed)
    aa = rs.randn(B * N * 24, 3).astype(np.float32) * 0.3
    rm = np.asarray(j_rodrigues(jnp.asarray(aa))).reshape(B, N, 24, 3, 3)
    xy = rs.uniform(0, 1800, (B, N, 2)).astype(np.float32)
    wh = rs.uniform(30, 300, (B, N, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    mask = np.ones((B, N), bool)
    mask[0, 3:] = False
    return rm, boxes, mask


@pytest.fixture(scope="module")
def jassets_():
    return jassets.synthesize_assets()


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


@pytest.fixture(scope="module")
def jax_modules():
    out = {}
    for v in (0, 1):
        mod = jrel.PoseRelationModule(**KWARGS[v])
        out[v] = (mod, jtrain.load_relation_weights(WEIGHTS[v], mod,
                                                    n_players=N))
    return out


@pytest.mark.parametrize("dim_g", [8, 64])
def test_bbox_positional_embedding_matches_jax(dim_g):
    _, boxes, _ = random_frame(1)
    want = np.asarray(jrel.bbox_positional_embedding(jnp.asarray(boxes),
                                                     dim_g))
    got = trel.bbox_positional_embedding(_t(boxes), dim_g).numpy()
    assert got.shape == want.shape == (B, N, N, dim_g)
    # The sines' arguments, in float64 from the boxes.
    b = boxes.astype(np.float64)
    c = (b[..., :2] + b[..., 2:]) / 2
    s = b[..., 2:] - b[..., :2] + 1
    d = np.abs((c[..., :, None, :] - c[..., None, :, :])
               / s[..., :, None, :])
    pos = np.concatenate([np.log(np.maximum(d, 1e-3)),
                          np.log(s[..., :, None, :] / s[..., None, :, :])],
                         -1)
    nf = dim_g // 8
    inv = 1.0 / np.power(1000.0, np.arange(nf) / nf)
    ang = (100.0 * pos[..., None] * inv).reshape(B, N, N, 4 * nf)
    ang = np.concatenate([ang, ang], -1)
    gap = np.abs(got - want)
    print("embedding gap: max abs %.3g, max relative to the argument %.3g"
          % (gap.max(), (gap / (1 + np.abs(ang))).max()))
    assert (gap <= EMBED_REL * (1 + np.abs(ang))).all()


@pytest.mark.parametrize("version", [0, 1])
def test_relation_module_matches_flax(version, jax_modules):
    mod, params = jax_modules[version]
    rm, boxes, mask = random_frame()
    want = np.asarray(mod.apply(params, jnp.asarray(rm), jnp.asarray(boxes),
                                jnp.asarray(mask)))
    model = convert.load_relation_weights(WEIGHTS[version], "cpu")
    assert (model.lift_dim is None) == (version == 0)
    with torch.no_grad():
        got = model(_t(rm), _t(boxes), _t(mask)).numpy()
    print("v%d module gap %.3g" % (version, np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL)
    np.testing.assert_array_equal(got[0, 3:], rm[0, 3:])
    # The module changes the real players.
    assert np.abs(got[mask] - rm[mask]).max() > 1e-3


def test_relation_weights_map_to_linear_layers():
    flat = dict(np.load(WEIGHTS[1]))
    model = convert.load_relation_weights(WEIGHTS[1], "cpu")
    k = flat["params/WQ/kernel"]
    assert model.WQ.weight.shape == (16 * 64, 1024)
    np.testing.assert_array_equal(model.WQ.weight.detach().numpy(),
                                  k.reshape(1024, -1).T)
    np.testing.assert_array_equal(model.WG.weight.detach().numpy(),
                                  flat["params/WG/kernel"].T)
    assert model.geo_dim == 64 and model.n_relations == 16


def test_synth_relation_batch_matches_jax():
    key = jax.random.PRNGKey(7)
    want = jtrain.synth_relation_batch(key, b=B, n_players=N)
    got = ttrain.synth_relation_batch(jax_relation_draws(key, B, N))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in ("rotmats_gt", "rotmats_noisy"):
        gap = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        print("%s gap %.3g" % (k, gap))
        assert gap <= BATCH_TOL, k
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=BATCH_TOL, atol=0)


def test_evaluate_relation_matches_jax(jax_modules, jassets_, assets):
    seed = 50_000_000
    mod, params = jax_modules[0]
    want = jtrain.evaluate_relation(mod, params, jassets_, n_batches=1, b=B,
                                    n_players=N, seed=seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    model = convert.load_relation_weights(WEIGHTS[0], "cpu")
    got = ttrain.evaluate_relation(
        model, assets, draws=[jax_relation_draws(key, B, N)], device="cpu")
    assert got["n_scenes"] == want["n_scenes"] == B
    gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want
            if k != "n_scenes"}
    print("evaluate_relation relative gaps:", gaps)
    assert len(gaps) == 6 and max(gaps.values()) <= METRIC_REL, gaps
    assert got["mse_out"] < got["mse_in"]


def test_sampled_relation_draws_evaluate_on_cpu(assets):
    """The port's own sampler: shapes, at least two real players, and the
    module improving on its input."""
    gen = torch.Generator().manual_seed(0)
    d = ttrain.sample_relation_draws(gen, b=3, n_players=N)
    batch = ttrain.synth_relation_batch(d)
    assert batch["rotmats_noisy"].shape == (3, N, 24, 3, 3)
    assert batch["boxes"].shape == (3, N, 4)
    assert (batch["mask"].sum(1) >= 2).all()
    model = convert.load_relation_weights(WEIGHTS[1], "cpu")
    res = ttrain.evaluate_relation(model, assets, n_batches=1, b=3,
                                   n_players=N, device="cpu")
    assert all(np.isfinite(v) for v in res.values())
    assert res["mse_out"] < res["mse_in"]
