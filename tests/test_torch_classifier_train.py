"""The port's frame-classifier training
(``pipeline/classification.py:train_classifier``) against the JAX
package's, and ``scripts/train_classifier_torch.py`` on the CPU.

* ``train_classifier`` from JAX's initial head (``ClassifyNet.init`` with
  the same seed, carried across by ``convert.classifier_state_dict_from_
  flat``) on seeded (N, 1000) features: the same validation split and
  epoch orders (one ``RandomState``), each epoch's mean training loss
  within 1e-5 of max(1, |loss|), the final head within 1e-5 but for
  Adam's near-zero-moment scalars (counted, printed, at most 0.01% of
  them, each within 2·lr: 3 of 500,000 at lr 1e-3), the validation hits
  equal;
* the script's ``build_dataset`` (frames rendered through K3's PyTorch
  mirror, ``test_torch_e2e_eval.fast_raster``): balanced labels, the
  gate's 224² preprocessing; and its ``main`` at a smoke size on the CPU,
  whose bundle JAX's ``load_classifier`` reads and whose gate decides as
  the port's.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.models.classifier import (  # noqa: E402
    ClassifyNet as JClassifyNet)
from soccerplayershapepose_tpu.pipeline import classification as jcls  # noqa

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.models.classifier import ClassifyNet  # noqa
from soccerplayershapepose_torch.pipeline import classification as tcls  # noqa
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_classifier_torch as script  # noqa: E402

TOL = 1e-5
# Scalars whose Adam steps sit where the second moment is ~0, so fp32
# gradient gaps swing a step's size: at most this share, each < 2·lr.
MAX_FLIP_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_features(n=150, seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 2, n).astype(np.int32)
    feats = rs.randn(n, 1000).astype(np.float32) + labels[:, None] * 0.3
    return feats, labels


def head_from_jax(variables):
    flat = convert.flatten_tree({"head": variables})
    head = ClassifyNet()
    head.load_state_dict(convert.classifier_state_dict_from_flat(flat)[
        "head"])
    return head


@pytest.mark.parametrize("seed, batch_size, lr", [(0, 64, 2e-4),
                                                  (5, 16, 1e-3)])
def test_train_classifier_matches_jax(seed, batch_size, lr):
    feats, labels = seeded_features(seed=seed)
    jparams, jhist = jcls.train_classifier(feats, labels, epochs=3, lr=lr,
                                           batch_size=batch_size, seed=seed)
    init = JClassifyNet().init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, feats.shape[1])))
    head, hist = tcls.train_classifier(
        feats, labels, epochs=3, lr=lr, batch_size=batch_size, seed=seed,
        head=head_from_jax(jax.device_get(init)), device="cpu")
    # The same validation rows right each epoch (JAX's float32 mean of the
    # hits may sit an ulp from the port's).
    n_val = max(1, int(len(feats) * 0.1))
    assert (np.rint(np.array(hist["val_acc"]) * n_val).tolist()
            == np.rint(np.array(jhist["val_acc"]) * n_val).tolist())
    # The loss within 1e-5 of max(1, |loss|): at lr 1e-3 it falls to 8e-4,
    # where the cross-entropy's cancellation leaves fp32 ~4e-5 relative.
    gap = np.abs(np.array(hist["train_loss"]) - np.array(jhist["train_loss"]))
    assert (gap <= TOL * np.maximum(1.0, np.abs(jhist["train_loss"]))).all()
    want = convert.flatten_tree({"head": jax.device_get(jparams)})
    got = convert.classifier_flat_from_modules(head)
    assert set(got) == set(want)
    flips = total = 0
    for k, w in want.items():
        gap = np.abs(got[k] - np.asarray(w))
        far = gap > TOL
        assert (gap[far] <= 2 * lr).all(), (k, gap.max())
        flips += int(far.sum())
        total += gap.size
    print("head scalars beyond %g: %d of %d" % (TOL, flips, total))
    assert flips <= MAX_FLIP_SHARE * total
    assert not head.training


def test_train_classifier_default_init_learns():
    feats, labels = seeded_features(seed=2)
    head, hist = tcls.train_classifier(feats, labels, epochs=8, lr=1e-3,
                                       batch_size=16, seed=2, device="cpu")
    assert len(hist["train_loss"]) == 8
    assert hist["train_loss"][-1] < hist["train_loss"][0]


def test_build_dataset_balanced(fast_raster):
    assets = synthesize_assets()
    images, labels = script.build_dataset(assets, 8, seed=1, batch=2,
                                          device="cpu")
    assert images.shape == (8, 224, 224, 3) and images.dtype == np.float32
    assert labels.tolist() == [1] * 4 + [0] * 4
    assert 0.0 <= images.min() and images.max() <= 1.0
    # The three kinds differ: wide frames, close-ups, empty pitches.
    assert np.abs(images[0] - images[4]).mean() > 0.01


def test_script_main_writes_a_bundle_jax_reads(fast_raster, tmp_path,
                                               capsys):
    out = str(tmp_path / "cls.npz")
    assert script.main(["--out", out, "--frames", "8", "--eval-frames", "4",
                        "--epochs", "2", "--batch", "2", "--device",
                        "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_train"] == 8 and rec["n_eval"] == 4 and rec["epochs"] == 2
    assert len(rec["val_acc_history"]) == 2
    with open(os.path.join(str(tmp_path), "cls_eval.json")) as f:
        assert json.load(f)["accuracy"] == rec["accuracy"]
    jgate = jcls.load_classifier(out)
    tgate = tcls.load_classifier(out, "cpu")
    frame = (np.random.RandomState(0).rand(256, 448, 3) * 255).astype(
        np.uint8)
    assert tgate(frame) == jgate(frame)
