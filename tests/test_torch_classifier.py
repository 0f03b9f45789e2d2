"""The port's frame classifier (``models/classifier.py``,
``pipeline/classification.py``, ``convert.load_classifier_weights``)
against the JAX package's, on the committed ``weights/frame_classifier.npz``
(ResNet-18 features and the ClassifyNet head) and on 3 seeded 270×480
frames:

* ``preprocess_frame`` bit-equal;
* the 1000 features and the 2 class logits within 1e-4 of JAX relative to
  their largest magnitude (fp32 convolutions summed in another order);
* equal decisions;
* a bundle the port saves (the committed features, a freshly seeded head)
  loads in JAX and gives JAX's decisions and logits; one JAX saves
  (randomly initialised features and head) loads in the port and gives
  the same; a head-only bundle round-trips and takes feature vectors;
* the port's saved keys, shapes and values equal the committed file's;
* ``load_classifier`` is strict: a missing or an unknown key raises.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.classifier import (  # noqa: E402
    ClassifyNet as JClassifyNet)
from soccerplayershapepose_tpu.pipeline import (  # noqa: E402
    classification as jcls)

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.classifier import (  # noqa: E402
    ClassifyNet)
from soccerplayershapepose_torch.pipeline import (  # noqa: E402
    classification as tcls)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "frame_classifier.npz")
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """3 seeded 270×480 frames: noise, a green pitch with noise, and a
    dark frame with a bright band."""
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 255, (270, 480, 3)).astype(np.uint8)
    pitch = np.clip(np.array([50, 140, 60]) + rng.randint(-30, 31,
                                                          (270, 480, 3)),
                    0, 255).astype(np.uint8)
    dark = rng.randint(0, 40, (270, 480, 3)).astype(np.uint8)
    dark[100:160] = 220
    return [noise, pitch, dark]


@pytest.fixture(scope="module")
def gates():
    return tcls.load_classifier(WEIGHTS, "cpu"), jcls.load_classifier(WEIGHTS)


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def jax_logits(gate, frame):
    feats = gate.feature_fn(frame)
    return np.asarray(gate.net.apply(gate.params, jnp.asarray(feats[None])))[0]


def test_preprocess_frame_bit_equal(frames):
    for f in frames + [frames[0][:100, :90], frames[1][:, :300]]:
        got, want = tcls.preprocess_frame(f), jcls.preprocess_frame(f)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k", range(3))
def test_features_logits_and_decision_match_jax(gates, frames, k):
    tgate, jgate = gates
    f = frames[k]
    assert rel(tgate.feature_fn(f), jgate.feature_fn(f)) <= REL_TOL
    got, want = tgate.logits(f), jax_logits(jgate, f)
    assert got.shape == (2,) and rel(got, want) <= REL_TOL
    assert tgate(f) == jgate(f) == tgate.process(f)


def test_port_bundle_loads_in_jax(tmp_path, gates, frames):
    _, features = convert.load_classifier_weights(WEIGHTS, "cpu")
    torch.manual_seed(0)
    head = ClassifyNet()
    path = str(tmp_path / "port.npz")
    tcls.save_classifier(path, head, features)
    jgate = jcls.load_classifier(path)
    tgate = tcls.make_frame_classifier(head, features, "cpu")
    for f in frames:
        assert rel(tgate.logits(f), jax_logits(jgate, f)) <= REL_TOL
        assert tgate(f) == jgate(f)


def test_jax_bundle_loads_in_port(tmp_path, frames):
    head = JClassifyNet().init(jax.random.PRNGKey(3), jnp.zeros((1, 1000)))
    feats = jcls.FrameFeatureNet().init(jax.random.PRNGKey(4),
                                        jnp.zeros((1, 224, 224, 3)))
    path = str(tmp_path / "jax.npz")
    jcls.save_classifier(path, head, feats)
    tgate = tcls.load_classifier(path, "cpu")
    jgate = jcls.make_frame_classifier(head, feats)
    for f in frames:
        assert rel(tgate.feature_fn(f), jgate.feature_fn(f)) <= REL_TOL
        assert rel(tgate.logits(f), jax_logits(jgate, f)) <= REL_TOL
        assert tgate(f) == jgate(f)


def test_head_only_bundle_round_trip(tmp_path):
    torch.manual_seed(1)
    head = ClassifyNet()
    path = str(tmp_path / "head.npz")
    tcls.save_classifier(path, head)
    assert sorted(np.load(path).files) == [
        "head/params/Dense_%d/%s" % (k, leaf)
        for k in (0, 1) for leaf in ("bias", "kernel")]
    tgate, jgate = tcls.load_classifier(path, "cpu"), jcls.load_classifier(
        path)
    feats = np.random.RandomState(2).randn(4, 1000).astype(np.float32)
    for x in feats:
        want = np.asarray(jgate.net.apply(jgate.params,
                                          jnp.asarray(x[None])))[0]
        assert rel(tgate.logits(x), want) <= REL_TOL
        assert tgate(x) == jgate(x)


def test_saved_bundle_equals_committed_file(tmp_path):
    head, features = convert.load_classifier_weights(WEIGHTS, "cpu")
    flat = convert.classifier_flat_from_modules(head, features)
    with np.load(WEIGHTS) as z:
        assert sorted(flat) == sorted(z.files)
        for k in z.files:
            assert flat[k].shape == z[k].shape, k
            assert np.array_equal(flat[k], z[k].astype(np.float32)), k


@pytest.mark.parametrize("mutation", ["missing_stat", "missing_head",
                                      "unknown"])
def test_load_classifier_is_strict(tmp_path, mutation):
    with np.load(WEIGHTS) as z:
        flat = {k: z[k] for k in z.files}
    if mutation == "missing_stat":
        del flat["features/batch_stats/ResNet_0/BasicBlock_3/BatchNorm_1/var"]
    elif mutation == "missing_head":
        del flat["head/params/Dense_1/bias"]
    else:
        flat["head/params/Dense_2/bias"] = np.zeros(2, np.float32)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **flat)
    with pytest.raises((KeyError, ValueError)):
        tcls.load_classifier(path, "cpu")
