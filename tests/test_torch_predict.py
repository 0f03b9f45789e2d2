"""The port's predict stage against the JAX package.

* heatmaps bit-equal (truncated centres, the linspace window, the unwritten
  last row and column, the strict contribution tests);
* the proxy representation exact, the JAX NHWC output transposed to NCHW;
* ResNet-18 + IEF on the committed ``weights/regressor_18ch_f16.npz`` at
  B=2: camera, pose and shape ≤ 1e-4 max abs (fp32 convolutions and sums in
  another order), and a ResNet-50 regressor on seeded random weights at the
  same tolerance;
* every ``PredictOutput`` field of ``predict_smpl`` ≤ 1e-4 max abs, the
  projected joints in the normalised [-1, 1] frame (pixels ÷ 256): in
  pixels they reach 512, where one fp32 ulp is 6.1e-5;
* the Procrustes and scale-translation alignments ≤ 1e-5 max abs.
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
from soccerplayershapepose_tpu.ops import alignment as jalign  # noqa: E402
from soccerplayershapepose_tpu.ops import heatmaps as jhm  # noqa: E402
from soccerplayershapepose_tpu.pipeline import predict as jpred  # noqa: E402
from soccerplayershapepose_tpu.pipeline import proxy as jproxy  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.ief import (  # noqa: E402
    default_initial_params)
from soccerplayershapepose_torch.models.regressor import (  # noqa: E402
    SingleInputRegressor)
from soccerplayershapepose_torch.ops import alignment as talign  # noqa: E402
from soccerplayershapepose_torch.ops import heatmaps as thm  # noqa: E402
from soccerplayershapepose_torch.pipeline import predict as tpred  # noqa: E402
from soccerplayershapepose_torch.pipeline import proxy as tproxy  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
NET_TOL = 1e-4
ALIGN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nest(flat: dict) -> dict:
    """Flat ``a/b/c`` keys → the nested fp32 variables flax applies."""
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.asarray(arr, np.float32))
    return out


@pytest.fixture(scope="module")
def flat_weights():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def crops():
    """Two 512² crops: blob silhouettes and keypoints, one joint dropped
    far off-frame and one on the last pixel row."""
    rng = np.random.RandomState(0)
    b, wh = 2, 512
    yy, xx = np.mgrid[:wh, :wh]
    sil = np.stack([((xx - 250 - 20 * i) ** 2 / 90 ** 2
                     + (yy - 260) ** 2 / 200 ** 2 < 1) for i in range(b)])
    sil = (sil & (rng.rand(b, wh, wh) > 0.02)).astype(np.float32)
    j2d = rng.uniform(60, 450, (b, 17, 2)).astype(np.float32)
    j2d[0, 3] = -1.0e4
    j2d[1, 5] = (300.7, 511.9)
    return sil, j2d


@pytest.fixture(scope="module")
def jax_predict(flat_weights, crops):
    sil, j2d = crops
    reg = jreg.SingleInputRegressor(in_channels=18, resnet_layers=18)
    fn = jax.jit(lambda v, a, s, j: jpred.predict_smpl(reg, v, a, s, j))
    out = fn(_nest(flat_weights), jassets.synthesize_assets(),
             jnp.asarray(sil), jnp.asarray(j2d))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


@pytest.mark.parametrize("wh", [256, 64])
def test_heatmaps_bit_equal(wh):
    rng = np.random.RandomState(wh)
    j = rng.uniform(-12, wh + 12, (3, 17, 2)).astype(np.float32)
    j[0, :4] = [[-8.5, 10.0], [-7.9, 10.0], [wh + 6.9, 3.0],
                [wh + 7.2, 3.0]]                  # the strict-edge cases
    j[1, 0] = [wh - 1, wh - 1]                    # last row and column
    want = np.asarray(jhm.joints2d_to_gaussian_heatmaps(jnp.asarray(j), wh))
    got = thm.joints2d_to_gaussian_heatmaps(torch.from_numpy(j), wh).numpy()
    np.testing.assert_array_equal(got, want)
    nhwc = np.asarray(jhm.joints2d_to_gaussian_heatmaps_nhwc(jnp.asarray(j),
                                                              wh))
    np.testing.assert_array_equal(got, np.moveaxis(nhwc, -1, -3))
    assert (got[..., -1, :] == 0).all() and (got[..., :, -1] == 0).all()


@pytest.mark.parametrize("in_wh", [512, 64, 300])
def test_proxy_exact(in_wh, crops):
    sil, j2d = crops
    sil = sil[:, :in_wh, :in_wh]
    j2d = j2d * (in_wh / 512.0)
    want = np.asarray(jproxy.create_proxy_representation(
        jnp.asarray(sil), jnp.asarray(j2d), in_wh=in_wh))
    got = tproxy.create_proxy_representation(
        torch.from_numpy(sil), torch.from_numpy(j2d), in_wh=in_wh).numpy()
    assert got.shape == (2, 18, 256, 256)
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_proxy_with_iuv_exact(crops):
    sil, j2d = crops
    iuv = np.random.RandomState(3).rand(2, 512, 512, 3).astype(np.float32)
    for keep_sil in (True, False):
        want = np.asarray(jproxy.create_proxy_representation(
            jnp.asarray(sil), jnp.asarray(j2d), iuv=jnp.asarray(iuv),
            include_silhouette=keep_sil))
        got = tproxy.create_proxy_representation(
            torch.from_numpy(sil), torch.from_numpy(j2d),
            iuv=torch.from_numpy(iuv.transpose(0, 3, 1, 2).copy()),
            include_silhouette=keep_sil).numpy()
        np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_state_dict_conversion_covers_the_regressor(flat_weights):
    sd = convert.regressor_state_dict_from_flat(flat_weights)
    model = SingleInputRegressor(18, 18)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    k = flat_weights["params/ResNet_0/BasicBlock_2/Conv_2/kernel"]
    np.testing.assert_array_equal(
        sd["encoder.blocks.2.convs.2.weight"].numpy(),
        k.astype(np.float32).transpose(3, 2, 0, 1))
    d = flat_weights["params/IEFModule_0/Dense_0/kernel"]
    np.testing.assert_array_equal(sd["ief.fcs.0.weight"].numpy(),
                                  d.astype(np.float32).T)
    assert all(v.dtype == torch.float32 for v in sd.values())


def _regressor_outputs(reg_j, variables, model, proxy_nhwc, assets):
    init = j_init(jnp.asarray(assets.mean_pose_rot6d.numpy()),
                  jnp.asarray(assets.mean_shape.numpy()))
    want = jax.jit(reg_j.apply)(variables, jnp.asarray(proxy_nhwc), init)
    with torch.no_grad():
        got = model(torch.from_numpy(proxy_nhwc.transpose(0, 3, 1, 2).copy()),
                    default_initial_params(assets.mean_pose_rot6d,
                                           assets.mean_shape))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_resnet18_ief_matches_jax_on_committed_weights(flat_weights, crops):
    sil, j2d = crops
    proxy = np.asarray(jproxy.create_proxy_representation(
        jnp.asarray(sil), jnp.asarray(j2d)))
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    got, want = _regressor_outputs(
        jreg.SingleInputRegressor(18, 18), _nest(flat_weights), model, proxy,
        synthesize_assets())
    for g, w, name in zip(got, want, ("cam", "pose", "betas")):
        assert np.abs(g - w).max() <= NET_TOL, name


def test_resnet50_ief_matches_jax_on_random_weights():
    """The bottleneck blocks and the converter's ``Bottleneck_i`` names, on
    seeded random weights shaped as flax initialises them."""
    reg_j = jreg.SingleInputRegressor(in_channels=18, resnet_layers=50)
    shapes = jax.eval_shape(reg_j.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 18)), jnp.zeros((157,)))
    flat = {}
    rng = np.random.RandomState(5)
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[coll])[0]:
            key = "/".join([coll] + [p.key for p in path])
            shape = leaf.shape
            if key.endswith("/var"):
                a = rng.uniform(0.5, 1.5, shape)
            elif key.endswith("/kernel"):
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            else:
                a = rng.randn(*shape) * 0.1
            flat[key] = a.astype(np.float32)
    model = SingleInputRegressor(18, 50)
    model.load_state_dict(convert.regressor_state_dict_from_flat(flat),
                          strict=False)
    proxy = np.random.RandomState(6).rand(1, 64, 64, 18).astype(np.float32)
    got, want = _regressor_outputs(reg_j, _nest(flat), model.eval(), proxy,
                                   synthesize_assets())
    for g, w, name in zip(got, want, ("cam", "pose", "betas")):
        assert np.abs(g - w).max() <= NET_TOL, name


def test_predict_smpl_matches_jax(crops, jax_predict):
    sil, j2d = crops
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    out = tpred.predict_smpl(model, synthesize_assets(), sil, j2d,
                             device="cpu")
    assert set(out._fields) == set(jax_predict)
    for name in out._fields:
        got = getattr(out, name).numpy()
        assert got.shape == jax_predict[name].shape, name
        err = np.abs(got - jax_predict[name]).max()
        if name == "joints2d_kprcnn":
            err = err / (512 / 2.0)
        assert err <= NET_TOL, (name, err)


def test_build_predictor_runs_on_cpu(crops):
    sil, j2d = crops
    reg, fn = tpred.build_predictor(seed=1, device="cpu")
    reg2, _ = tpred.build_predictor(seed=1, device="cpu")
    w = reg.encoder.conv.weight
    assert torch.equal(w, reg2.encoder.conv.weight) and w.device.type == "cpu"
    out = fn(synthesize_assets(), sil[:1], j2d[:1])
    assert out.vertices.shape == (1, 6890, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out)


def _point_sets(seed=0, b=3, n=17):
    rng = np.random.RandomState(seed)
    s2 = rng.randn(b, n, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(b, 3, 3))
    s1 = 1.7 * np.einsum("bij,bnj->bni", q, s2) + rng.randn(b, 1, 3) \
        + rng.randn(b, n, 3) * 0.05
    return s1.astype(np.float32), s2


@pytest.mark.parametrize("seed", [0, 1])
def test_alignments_match_jax(seed):
    s1, s2 = _point_sets(seed)
    for jfn, tfn in ((jalign.procrustes_align, talign.procrustes_align),
                     (jalign.scale_and_translation_align,
                      talign.scale_and_translation_align)):
        want = np.asarray(jfn(jnp.asarray(s1), jnp.asarray(s2)))
        got = tfn(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ALIGN_TOL)
    # a reflection is not a rotation: the determinant's sign fix
    mirrored = s2 * np.array([1, 1, -1], np.float32)
    want = np.asarray(jalign.procrustes_align(jnp.asarray(mirrored),
                                              jnp.asarray(s2)))
    got = talign.procrustes_align(torch.from_numpy(mirrored),
                                  torch.from_numpy(s2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ALIGN_TOL)
