"""The port's ProxyNet (R18-FPN trunk and dense heads), its decoders and its
weight loader against the JAX package's ``models/perception.py`` and
``models/backbone.py``.

On the committed ``weights/proxynet_256_f16.npz`` (float16, cast to fp32 as
flax promotes them), one seeded batch (B = 2, 128², numpy):

* every head's logits (keypoints, mask, parts, UV) and every FPN level
  against flax ``ProxyNet.apply`` on ``load_perception_weights``: ≤ 1e-4
  max abs (NHWC against NCHW convolutions, fp32 sums in another order);
* the decoders on JAX's own logits (the net's, and standard-normal ones
  that light every part): part ids exact, keypoint x, y ≤ 1e-4
  px and scores ≤ 1e-6, U, V ≤ 1e-3 on their 0-255 scale. A part id
  decided by two bilinearly upsampled logits within 1e-4 of each other
  may go either way: such near-ties are counted and printed, and the ids
  must agree everywhere else;
* the strict loader: a missing or an extra variable raises; without
  ``device="cpu"`` on a machine without CUDA, it raises.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models import backbone as jbackbone  # noqa
from soccerplayershapepose_tpu.models import perception as jperc  # noqa: E402
from soccerplayershapepose_tpu.train.perception import (  # noqa: E402
    load_perception_weights)

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models import backbone as tbackbone  # noqa
from soccerplayershapepose_torch.models import perception as tperc  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "proxynet_256_f16.npz")
B, WH = 2, 128
HEAD_TOL = 1e-4
KP_XY_TOL = 1e-4
KP_SCORE_TOL = 1e-6
UV_TOL = 1e-3
PART_TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(B, WH, WH, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_net():
    model = jperc.ProxyNet(with_iuv=True)
    return model, load_perception_weights(WEIGHTS, model, wh=WH)


@pytest.fixture(scope="module")
def jax_out(jax_net, images):
    model, variables = jax_net
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    return [np.array(o) for o in out]


@pytest.fixture(scope="module")
def port_net():
    return convert.load_proxynet_weights(WEIGHTS, "cpu")


def test_proxynet_heads_match_flax(port_net, jax_out, images):
    with torch.no_grad():
        got = port_net(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.kp_logits.shape == (B, WH // 4, WH // 4, 17)
    assert got.mask_logits.shape == (B, WH, WH)
    assert got.part_logits.shape == (B, WH // 4, WH // 4, 25)
    assert got.uv.shape == (B, WH // 4, WH // 4, 48)
    for name, g, w in zip(tperc.ProxyNetOutput._fields, got, jax_out):
        err = float(np.abs(g.numpy() - w).max())
        print("%s: max abs %.3g (|logit| up to %.3g)"
              % (name, err, np.abs(w).max()))
        assert err <= HEAD_TOL, name


def test_fpn_pyramid_matches_flax(jax_net, port_net, images):
    _, variables = jax_net
    trunk_vars = {k: variables[k]["FPNTrunk_0"] for k in variables}
    _, want = jbackbone.fpn_trunk_r18(128).apply(
        trunk_vars, jnp.asarray(images * 2.0 - 1.0), train=False)
    with torch.no_grad():
        _, got = port_net.trunk(torch.from_numpy(images * 2.0 - 1.0)
                                .permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape[2] == WH // 4 // 2 ** level
        err = float(np.abs(g.permute(0, 2, 3, 1).numpy() - w).max())
        assert err <= HEAD_TOL, (level, err)


def test_upsample2x_matches_jax():
    x = np.random.RandomState(1).rand(2, 3, 4, 5).astype(np.float32)
    want = np.asarray(jbackbone.upsample2x(jnp.asarray(x.transpose(0, 2, 3,
                                                                    1))))
    got = tbackbone.upsample2x(torch.from_numpy(x)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_keypoints_on_jax_logits(jax_out):
    kp_logits = jax_out[0]
    # The net's own heatmaps, and the same boxed as the extractor boxes
    # them (−1e9 outside a window), whose edges exercise the clips.
    boxed = np.full_like(kp_logits, -1e9)
    boxed[:, 5:20, 3:12] = kp_logits[:, 5:20, 3:12]
    for logits in (kp_logits, boxed):
        want = np.asarray(jperc.decode_keypoints(jnp.asarray(logits)))
        got = tperc.decode_keypoints(torch.from_numpy(logits)).numpy()
        np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                                   atol=KP_XY_TOL)
        np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                                   atol=KP_SCORE_TOL)


def test_decode_silhouette_on_jax_logits(jax_out):
    want = np.asarray(jperc.decode_silhouette(jnp.asarray(jax_out[1])))
    got = tperc.decode_silhouette(torch.from_numpy(jax_out[1])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["net", "normal"])
@pytest.mark.parametrize("out_wh", [None, WH])
def test_decode_iuv_on_jax_logits(jax_out, out_wh, source):
    """On the net's logits (a noise image: mostly background) and on
    standard-normal logits ×3 (every part wins somewhere)."""
    part, uv = jax_out[2], jax_out[3]
    if source == "normal":
        rng = np.random.RandomState(2)
        part = (rng.randn(*part.shape) * 3).astype(np.float32)
        uv = (rng.randn(*uv.shape) * 3).astype(np.float32)
    want = np.asarray(jperc.decode_iuv(jnp.asarray(part), jnp.asarray(uv),
                                       out_wh=out_wh))
    got = tperc.decode_iuv(torch.from_numpy(part), torch.from_numpy(uv),
                           out_wh=out_wh).numpy()
    # Near-ties: the top two of the (upsampled) part logits within
    # PART_TIE, read from the port's own upsampling.
    up = torch.from_numpy(part)
    if out_wh is not None:
        up = torch.nn.functional.interpolate(
            up.permute(0, 3, 1, 2), size=(out_wh, out_wh), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
    top2 = torch.topk(up, 2, dim=-1).values.numpy()
    tie = (top2[..., 0] - top2[..., 1]) < PART_TIE
    apart = got[..., 0] != want[..., 0]
    print("part ids apart: %d, near-ties: %d of %d pixels"
          % (apart.sum(), tie.sum(), apart.size))
    assert not (apart & ~tie).any()
    same = ~apart
    np.testing.assert_allclose(got[..., 1:][same], want[..., 1:][same],
                               rtol=0, atol=UV_TOL)
    if source == "normal":
        assert len(np.unique(want[..., 0])) == 25


def test_load_proxynet_weights_is_strict(tmp_path):
    with np.load(WEIGHTS) as z:
        flat = {k: z[k] for k in z.files}
    model = convert.load_proxynet_weights(WEIGHTS, "cpu")
    assert model.with_iuv and model.channels == 128
    assert not model.training
    missing = dict(flat)
    del missing["params/kp_tower/Conv_1/bias"]
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(ValueError, match="missing"):
        convert.load_proxynet_weights(str(tmp_path / "missing.npz"), "cpu")
    extra = dict(flat)
    extra["params/extra_head/kernel"] = np.zeros((1, 1, 128, 3), np.float16)
    np.savez(tmp_path / "extra.npz", **extra)
    with pytest.raises(ValueError, match="unexpected"):
        convert.load_proxynet_weights(str(tmp_path / "extra.npz"), "cpu")
    bad = dict(flat)
    bad["params/FPNTrunk_0/neck/lateral0/kernel"] = flat[
        "params/FPNTrunk_0/fpn/lateral0/kernel"]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(KeyError):
        convert.load_proxynet_weights(str(tmp_path / "bad.npz"), "cpu")


def test_entry_points_refuse_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_proxynet_weights(WEIGHTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProxyExtractor(tperc.ProxyNet(channels=8))
