"""The slice as a whole against the JAX package: the detector's held-out
evaluation and the full-frame pipeline, on narrow nets whose flax
initialisation is carried across (``convert``'s state-dict converters).

* ``evaluate_detector(n_batches=1, batch=2, hw=(64, 96), n_players=3)``
  on a ``channels=16`` detector, and its matching on detections that hit
  (both decoders replaced by the same boxes near the ground truth): every
  metric ≤ 1e-6 absolute. Both
  packages render the frames through K3's PyTorch mirror (JAX's through
  ``jax.pure_callback``), the port from the draws of JAX's key stream, so
  the two evaluate nearly the same pixels; the dense renders are held to
  each other in ``test_torch_synth_frame.py``.
* ``build_frame_pipeline(max_players=3, crop_wh=64)`` on 2 frames of
  64×96 (``tests/test_fullframe.py``'s shapes; a ``channels=16`` detector
  and ProxyNet without IUV, the 18-channel ResNet-18 regressor of
  ``build_predictor``), every output on every slot, valid or not, which
  the stable top-K makes possible: scores ≤ 1e-6, ``valid`` exact, square
  boxes ≤ 1e-4 px (4 · (cell + offset) ± size / 2 carries the heads'
  1e-6 gap at 64 px), camera, betas and rotations ≤ 1e-5, vertices ≤ 1e-5
  m and joints ≤ 1e-4 crop px (fp32 convolutions summed in another order
  through four nets); the crops ≤ 1e-6, and the decoded silhouettes and
  keypoints ≤ 1e-3 px, so no discrete flip hides in those bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import detector as jdet  # noqa: E402
from soccerplayershapepose_tpu.models import perception as jperc  # noqa: E402
from soccerplayershapepose_tpu.pipeline import fullframe as jff  # noqa: E402
from soccerplayershapepose_tpu.pipeline.predict import (  # noqa: E402
    build_predictor as j_build_predictor)
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import quality as jquality  # noqa: E402
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models import detector as tdet  # noqa: E402
from soccerplayershapepose_torch.models.detector import (  # noqa: E402
    PlayerDetector)
from soccerplayershapepose_torch.models.perception import (  # noqa: E402
    ProxyNet)
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.pipeline import fullframe as tff  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import quality as tquality  # noqa: E402
from soccerplayershapepose_torch.train import synth as tsynth  # noqa: E402

from test_torch_e2e_eval import _jax_fast_rasterize  # noqa: E402
from test_torch_extract import fast_rasterize_attributes  # noqa: E402
from test_torch_synth_frame import jax_frame_draws  # noqa: E402

HW = (64, 96)
K, CROP = 3, 64
METRIC_TOL = 1e-6
SCORE_TOL = 1e-6
BOX_TOL = 1e-4
PARAM_TOL = 1e-5
VERT_TOL = 1e-5
JOINT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(variables, prefix=""):
    """Nested flax variables → flat ``a/b/c`` keys of numpy arrays, as the
    committed npz files hold them."""
    out = {}
    for k, v in variables.items():
        name = prefix + k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = np.array(v)
    return out


def _loaded(model, state_dict):
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    assert not unexpected and all(
        k.endswith("num_batches_tracked") for k in missing)
    return model.eval()


@pytest.fixture(scope="module")
def detectors():
    jd = jdet.PlayerDetector(channels=16)
    jv = jd.init(jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)))
    td = _loaded(PlayerDetector(channels=16),
                 convert.detector_state_dict_from_flat(flatten(jv)))
    return jd, jv, td


@pytest.fixture(scope="module")
def proxynets():
    jp = jperc.ProxyNet(with_iuv=False, channels=16)
    jv = jp.init(jax.random.PRNGKey(1), jnp.zeros((1, CROP, CROP, 3)))
    tp = _loaded(ProxyNet(with_iuv=False, channels=16),
                 convert.proxynet_state_dict_from_flat(flatten(jv)))
    return jp, jv, tp


@pytest.fixture(scope="module")
def regressors():
    jr, jparams, _ = j_build_predictor(in_channels=18)
    tr = _loaded(SingleInputRegressor(in_channels=18, resnet_layers=18),
                 convert.regressor_state_dict_from_flat(flatten(jparams)))
    return jr, jparams, tr


@pytest.fixture(scope="module")
def assets():
    return synthesize_assets(), jassets.synthesize_assets()


@pytest.fixture(scope="module")
def fast_raster():
    """Both packages' frame rasterizer swapped for K3's mirror; JAX's frame
    function re-jitted, so that no trace of the dense oracle is reused."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tsynth, "rasterize_attributes", fast_rasterize_attributes)
    mp.setattr(jsynth, "rasterize_attributes", _jax_fast_rasterize)
    mp.setattr(jsynth, "synth_frame_batch", jax.jit(
        jsynth.synth_frame_batch.__wrapped__,
        static_argnames=("b", "n_players", "hw")))
    yield
    mp.undo()


def _eval_both(jd, jv, td, assets, **kw):
    want = jquality.evaluate_detector(jd, jv, assets[1], n_batches=1,
                                      batch=2, hw=HW, n_players=3, **kw)
    key = jax.random.PRNGKey(jquality.EVAL_SEED_BASE + 500_000)
    got = tquality.evaluate_detector(
        td, assets[0], hw=HW, draws=[jax_frame_draws(key, 2, 3, HW)],
        device="cpu", **kw)
    print({k: (got[k], want[k]) for k in want})
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= METRIC_TOL or (
                np.isnan(w) and np.isnan(got[k])), k
        else:
            assert got[k] == w, k
    return want


def test_evaluate_detector_matches_jax(detectors, assets, fast_raster):
    want = _eval_both(*detectors, assets)
    assert want["n_gt_boxes"] + want["n_ignored_gt_boxes"] > 0
    assert want["best_f1_score_thresh"] > 0        # detections were scored


def test_evaluate_detector_matching_matches_jax(detectors, assets,
                                                fast_raster, monkeypatch):
    """The host-side matching on detections that hit: both packages' decode
    replaced by one that returns, per frame, every ground-truth box of the
    batch (shifted by 0-2 px; IoU far from 0.5), a duplicate of the first,
    one box on nobody and one zero-score box, with seeded scores on both
    sides of 0.7, and the ignore rule raised to a fill of 0.5 so that it
    leaves some players out. True and false positives, ignored matches,
    the AP sum and the best-F1 point all take part."""
    key = jax.random.PRNGKey(jquality.EVAL_SEED_BASE + 500_000)
    gt = tsynth.render_frame_batch(assets[0],
                                   jax_frame_draws(key, 2, 3, HW), HW)
    rng = np.random.RandomState(3)
    boxes, scores = [], []
    for i in range(2):
        bx = gt["boxes"][i].numpy()[gt["mask"][i].numpy() > 0.5]
        bx = np.concatenate([bx + rng.uniform(0, 2, bx.shape), bx[:1] + 1.0,
                             [[5.0, 5.0, 15.0, 25.0], [0.0, 0.0, 1.0, 1.0]]])
        sc = np.concatenate([rng.uniform(0.5, 0.95, len(bx) - 1), [0.0]])
        boxes.append(bx.astype(np.float32))
        scores.append(sc.astype(np.float32))
    k = max(len(b) for b in boxes)
    pad = [(np.pad(b, ((0, k - len(b)), (0, 0))),
            np.pad(s, (0, k - len(s)))) for b, s in zip(boxes, scores)]
    fake_b = np.stack([p[0] for p in pad])
    fake_s = np.stack([p[1] for p in pad])
    monkeypatch.setattr(jdet, "decode_detections", lambda out, **kw:
                        jdet.Detections(jnp.asarray(fake_b),
                                        jnp.asarray(fake_s)))
    monkeypatch.setattr(tquality, "decode_detections", lambda out, **kw:
                        tdet.Detections(torch.from_numpy(fake_b),
                                        torch.from_numpy(fake_s)))
    want = _eval_both(*detectors, assets, ignore_below_fill=0.5)
    assert want["n_ignored_gt_boxes"] > 0 and want["n_gt_boxes"] > 0
    assert 0 < want["ap@0.5"] < 1 and want["mean_matched_iou"] > 0.5


def test_evaluate_detector_seeds_its_own_frames(detectors, assets,
                                                fast_raster):
    """Without draws the evaluation samples each batch from generators
    seeded EVAL_SEED_BASE + 500,000 + seed · 100,000 + bi, so a second
    run gives the same record, and refuses the CPU unless asked."""
    td = detectors[2]
    runs = [tquality.evaluate_detector(td, assets[0], n_batches=1, batch=2,
                                       hw=HW, n_players=3, seed=1,
                                       device="cpu") for _ in range(2)]
    assert runs[0]["eval_hw"] == list(HW)
    for k, v in runs[0].items():
        assert v == runs[1][k] or (np.isnan(v) and np.isnan(runs[1][k])), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tquality.evaluate_detector(td, assets[0], n_batches=1)


@pytest.fixture(scope="module")
def pipelines(detectors, proxynets, regressors, assets):
    frames = np.random.RandomState(0).rand(2, *HW, 3).astype(np.float32)
    jd, jdv, td = detectors
    jp, jpv, tp = proxynets
    jr, jrp, tr = regressors
    want = jff.build_frame_pipeline(jd, jdv, jp, jpv, jr, jrp,
                                    max_players=K, crop_wh=CROP)(
        assets[1], jnp.asarray(frames))
    fn = tff.build_frame_pipeline(td, tp, tr, max_players=K, crop_wh=CROP,
                                  device="cpu")
    got = fn(assets[0], frames)
    return frames, {k: np.asarray(v) for k, v in want._asdict().items()}, \
        {k: v.numpy() for k, v in got._asdict().items()}


def test_frame_pipeline_matches_jax(pipelines):
    _, want, got = pipelines
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=SCORE_TOL)
    assert len(np.unique(want["scores"])) > 1
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=BOX_TOL)
    for k in ("cam_wp", "betas", "pose_rotmats"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["vertices"], want["vertices"], rtol=0,
                               atol=VERT_TOL)
    np.testing.assert_allclose(got["joints2d"], want["joints2d"], rtol=0,
                               atol=JOINT_TOL)
    for k in want:
        print("%s: max abs %.3g" % (k, np.abs(got[k].astype(np.float64)
                                            - want[k]).max()))


def test_frame_pipeline_stages_match_jax(pipelines, proxynets):
    """The crops the pipeline cut and what ProxyNet decoded from them:
    silhouettes and keypoint cells identical (so the bounds above hold no
    discrete flip), keypoints ≤ 1e-3 px."""
    frames, want, _ = pipelines
    jp, jpv, tp = proxynets
    from soccerplayershapepose_tpu.ops.roi_align import roi_align as j_roi
    from soccerplayershapepose_torch.ops.roi_align import roi_align as t_roi
    from soccerplayershapepose_torch.models import perception as tperc
    sq = want["boxes"]
    j_crops = np.stack([np.asarray(j_roi(jnp.asarray(f), jnp.asarray(b),
                                         output_size=CROP, sampling_ratio=1))
                        for f, b in zip(frames, sq)]).reshape(-1, CROP, CROP,
                                                              3)
    t_crops = t_roi(torch.from_numpy(frames), torch.from_numpy(np.array(sq)),
                    output_size=CROP, sampling_ratio=1).reshape(
        -1, CROP, CROP, 3)
    np.testing.assert_allclose(t_crops.numpy(), j_crops, rtol=0, atol=1e-6)
    j_out = jp.apply(jpv, jnp.asarray(j_crops), train=False)
    with torch.no_grad():
        t_out = tp(t_crops.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        tperc.decode_silhouette(t_out.mask_logits).numpy(),
        np.asarray(jperc.decode_silhouette(j_out.mask_logits)))
    jk = np.asarray(jperc.decode_keypoints(j_out.kp_logits, stride=4))
    tk = tperc.decode_keypoints(t_out.kp_logits, stride=4).numpy()
    np.testing.assert_allclose(tk, jk, rtol=0, atol=1e-3)
