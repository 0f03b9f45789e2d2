"""The port's deployment-condition evaluations against the JAX package's:
``train/straps.py:evaluate_regressor_e2e`` (RGB crops → extractor →
18-channel proxy → regressor → metrics) and
``train/quality.py:evaluate_proxynet``, at ``n_batches=1`` on the draws of
the JAX key stream, on the committed ``weights/regressor_18ch_f16.npz`` and
``weights/proxynet_256_f16.npz``.

At 256², the size the ProxyNet weights were trained at (at 128² it finds
nobody), B = 2. Both packages render their crops through the same
z-buffer here, K3's PyTorch mirror (``test_torch_extract.
fast_rasterize_attributes``; JAX's through a host callback), because the
dense plain versions take about a minute per 256² batch on the CPU; the
dense rasterizers are held against each other in
``tests/test_torch_synth_rgb.py`` and ``tests/test_torch_synth_eval.py``.
Everything else is each package's own code on the same draws.

* ``evaluate_regressor_e2e``: counts (``n_images``,
  ``extraction_failures``) exact; each of the nine metrics ≤ 1e-3
  relative (the test prints the measured gap);
* ``evaluate_proxynet``: counts exact from JAX's draws, each package
  rendering its own crops; there the uint8 crops differ where SMPL's fp32
  ulps between the frameworks move an edge or a value across a level
  (counted, printed), which moves a joint by ~0.01 px and the median
  keypoint error by ~1.5e-3 relative, so the metrics are held, ≤ 1e-3
  relative, on JAX's own crops (printed gaps from the port's own crops);
* ``evaluate_regressor``'s ``proxy_fn``: a function of the batch replaces
  the ground-truth proxy (identity gives the same metrics; a blank proxy
  other ones);
* without ``device="cpu"`` on a machine without CUDA, the evaluations
  raise.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import regressor as jreg  # noqa: E402
from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.pipeline import extract as jextract  # noqa
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import quality as jquality  # noqa
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.pipeline import extract as textract  # noqa
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import quality as tquality  # noqa
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_extract import (  # noqa: E402
    fast_rasterize_attributes, nest_flat)
from test_torch_synth_rgb import jax_rgb_crop_draws  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGRESSOR = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
PROXYNET = os.path.join(REPO, "weights", "proxynet_256_f16.npz")
B, WH = 2, 256
SEED = 10_000_000          # evaluate_regressor_e2e's default seed
METRIC_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fast_rasterize(v2d, z, attrs, faces, img_wh):
    """JAX's ``rasterize_attributes`` answered by the same K3 mirror."""
    b, a = v2d.shape[0], attrs.shape[-1]

    def host(v2d, z, attrs, faces):
        out, mask = fast_rasterize_attributes(
            *(torch.from_numpy(np.array(x)) for x in (v2d, z, attrs, faces)),
            img_wh)
        return out.numpy(), mask.numpy()

    shapes = (jax.ShapeDtypeStruct((b, img_wh, img_wh, a), jnp.float32),
              jax.ShapeDtypeStruct((b, img_wh, img_wh), jnp.bool_))
    return jax.pure_callback(host, shapes, v2d, z, attrs, faces)


@pytest.fixture(scope="module")
def fast_raster():
    """Both packages' crop rasterizer swapped for the K3 mirror; JAX's crop
    function re-jitted so no trace of another test is reused."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    mp.setattr(jsynth, "rasterize_attributes", _jax_fast_rasterize)
    fresh = jax.jit(jsynth.synth_crop_batch.__wrapped__,
                    static_argnames=("b", "wh", "occluders", "domain_rand",
                                     "return_params", "with_image"))
    mp.setattr(jsynth, "synth_crop_batch", fresh)
    mp.setattr(jstraps, "synth_crop_batch", fresh)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def nets():
    jp = nest_flat(dict(np.load(PROXYNET)))
    jr = nest_flat(dict(np.load(REGRESSOR)))
    return {"jax_extractor": jextract.ProxyExtractor(JProxyNet(), jp, wh=WH),
            "jax_regressor": jr,
            "extractor": textract.ProxyExtractor(
                convert.load_proxynet_weights(PROXYNET, "cpu"), wh=WH,
                device="cpu"),
            "regressor": convert.load_regressor_weights(REGRESSOR, "cpu")}


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets()


def _gaps(got, want):
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want
            if isinstance(want[k], float) and np.isfinite(want[k])
            and want[k] != 0}


def test_evaluate_regressor_e2e_matches_jax(fast_raster, nets, assets):
    reg = jreg.SingleInputRegressor(in_channels=18, resnet_layers=18)
    jv = nets["jax_regressor"]
    want = jstraps.evaluate_regressor_e2e(
        reg, jv["params"], jv["batch_stats"], nets["jax_extractor"],
        jassets.synthesize_assets(), n_batches=1, batch=B, wh=WH, seed=SEED)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    times = {}
    got = tstraps.evaluate_regressor_e2e(
        nets["regressor"], nets["extractor"], assets, wh=WH,
        draws=[jax_rgb_crop_draws(key, B, WH)], stage_times=times,
        device="cpu")
    for k in ("n_images", "extraction_failures", "eval_wh", "via"):
        assert got[k] == want[k], k
    assert got["n_images"] > 0
    gaps = _gaps(got, want)
    print("evaluate_regressor_e2e relative gap per metric:", gaps)
    print("stage seconds:", times)
    assert len(gaps) == 9 and max(gaps.values()) <= METRIC_REL, gaps
    assert set(times) == {"synthesis", "proxynet", "extraction",
                          "regressor"}


@pytest.fixture(scope="module")
def jax_proxynet_eval(fast_raster, nets):
    """JAX's evaluate_proxynet and the crop batch it rendered."""
    seen = []
    inner = jsynth.synth_crop_batch

    def recording(*args, **kw):
        out = inner(*args, **kw)
        seen.append({k: np.asarray(v) for k, v in out.items()})
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jsynth, "synth_crop_batch", recording)
    try:
        want = jquality.evaluate_proxynet(
            nets["jax_extractor"], jassets.synthesize_assets(), n_batches=1,
            batch=B, wh=WH, seed=0)
    finally:
        mp.undo()
    return want, seen[0]


def _check_counts(got, want):
    for k in ("eval_wh", "n_images", "extraction_failures", "occluders",
              "domain_rand"):
        assert got[k] == want[k], k


def test_evaluate_proxynet_matches_jax(jax_proxynet_eval, nets, assets):
    """From JAX's draws, each package rendering its own crops: counts
    exact. The uint8 crops differ where SMPL's fp32 ulps move an edge or a
    value across a level, which moves a joint by ~0.01 px: the metric gaps
    are printed, and held to 1e-3 on JAX's own crops below."""
    want, jbatch = jax_proxynet_eval
    key = jax.random.PRNGKey(jquality.EVAL_SEED_BASE)
    draws = jax_rgb_crop_draws(key, B, WH)
    got = tquality.evaluate_proxynet(nets["extractor"], assets, wh=WH,
                                     draws=[draws])
    _check_counts(got, want)
    assert tquality.EVAL_SEED_BASE == jquality.EVAL_SEED_BASE
    image = tsynth.render_crop_batch(assets, draws, WH,
                                     with_image=True)["image"]
    g8 = tstraps.crop_images_u8(image).numpy().astype(int)
    w8 = (jbatch["image"] * 255.0).astype(np.uint8).astype(int)
    print("uint8 crops: %d of %d values apart, %d by more than one level"
          % ((g8 != w8).sum(), g8.size, (np.abs(g8 - w8) > 1).sum()))
    print("evaluate_proxynet relative gap per metric (own crops):",
          _gaps(got, want))


def test_evaluate_proxynet_on_jax_crops_matches_jax(jax_proxynet_eval, nets,
                                                    assets, monkeypatch):
    want, jbatch = jax_proxynet_eval
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    monkeypatch.setattr(tquality, "render_crop_batch",
                        lambda *a, **k: batch)
    got = tquality.evaluate_proxynet(nets["extractor"], assets, wh=WH,
                                     draws=[None])
    _check_counts(got, want)
    gaps = _gaps(got, want)
    print("evaluate_proxynet relative gap per metric (JAX's crops):", gaps)
    assert set(gaps) >= {"kp_median_px_err", "kp_pck@0.10bbox",
                         "mask_mean_iou", "iuv_part_acc"}
    assert max(gaps.values()) <= METRIC_REL, gaps


def test_rank_auc_and_bbox_extent_match_jax():
    rng = np.random.RandomState(5)
    pos = np.round(rng.rand(40), 1)          # ties on purpose
    neg = np.round(rng.rand(30) * 0.8, 1)
    assert tquality._rank_auc(pos, neg) == jquality._rank_auc(pos, neg)
    assert np.isnan(tquality._rank_auc(pos, neg[:0]))
    sil = np.zeros((20, 20))
    sil[3:9, 5:17] = 1
    assert tquality._bbox_extent(sil) == jquality._bbox_extent(sil) == 11.0


def test_evaluate_regressor_proxy_fn(assets):
    model = convert.load_regressor_weights(REGRESSOR, "cpu")
    d = [tstraps.sample_regressor_draws(torch.Generator().manual_seed(0), 2,
                                        32, corrupt=False)]
    base = tstraps.evaluate_regressor(model, assets, wh=32, draws=d,
                                      device="cpu")
    same = tstraps.evaluate_regressor(model, assets, wh=32, draws=d,
                                      proxy_fn=lambda b: b["proxy"],
                                      device="cpu")
    blank = tstraps.evaluate_regressor(
        model, assets, wh=32, draws=d, device="cpu",
        proxy_fn=lambda b: torch.zeros_like(b["proxy"]))
    assert same == base
    assert blank["pve_mm"] != base["pve_mm"]


def test_evaluations_refuse_cpu_without_asking(nets, assets):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstraps.evaluate_regressor_e2e(nets["regressor"], nets["extractor"],
                                       assets, n_batches=1, batch=1)
    with pytest.raises(ValueError, match="extractor"):
        tstraps.evaluate_regressor_e2e(nets["regressor"], nets["extractor"],
                                       assets, n_batches=1, batch=1,
                                       device="meta")
