"""The port's real-crop training source (``train/real_data.py``) against the
JAX package's, on the small crop and proxy tree of JAX's
``tests/test_real_data.py`` (64² crops, one player with IUV, one without,
a low-score and an off-frame joint).

* ``collect_proxy_examples``: the same records;
* ``proxy_tree_batches``: every array of every batch bit-equal, for two
  seeds, at the tree's size and resized (nearest mask, rescaled
  keypoints, the IUV sampled at stride 4), with and without ``loop``;
* ``mixed_batches``: the same sequence of real and synthetic picks and
  the same synthetic step numbers, including the fall-back to synthetic
  batches once the real iterator is exhausted;
* one port ProxyNet step on a real batch: finite losses, the crop without
  IUV weighted out of the part and UV losses.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import formats as jio  # noqa: E402
from soccerplayershapepose_tpu.train import real_data as jreal  # noqa: E402

from soccerplayershapepose_torch.models.perception import ProxyNet  # noqa
from soccerplayershapepose_torch.train import perception as ttrain  # noqa
from soccerplayershapepose_torch.train import real_data as treal  # noqa

WH = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def proxy_tree(tmp_path_factory):
    """JAX's fixture, plus a third player of another scene whose proxies
    are at 128² (the loader resizes them) and one view without proxies."""
    tmp = tmp_path_factory.mktemp("tree")
    image_root, proxy_root = str(tmp / "crops"), str(tmp / "proxy")
    rng = np.random.RandomState(0)
    for scene, player, with_iuv, native in (("s1", "2", True, WH),
                                            ("s1", "3", False, WH),
                                            ("s2", "2", True, 2 * WH)):
        d = os.path.join(image_root, "g1", scene, player)
        p = os.path.join(proxy_root, "g1", scene, player)
        os.makedirs(d), os.makedirs(p)
        jio.write_png(os.path.join(d, "view_1.png"),
                      rng.randint(0, 255, (WH, WH, 3), np.uint8))
        s = native / WH
        kp = np.concatenate([rng.uniform(5, 59, (17, 2)) * s,
                             rng.uniform(0.2, 1.0, (17, 1))], axis=1)
        kp[0, 2] = 0.01     # low-score joint → invisible
        kp[1, 0] = -5.0     # off-frame joint → invisible
        jio.write_joints2d(os.path.join(p, "view_1_j2d.xml"), kp)
        sil = np.zeros((native, native), np.uint8)
        sil[int(10 * s):int(50 * s), int(20 * s):int(44 * s)] = 1
        np.save(os.path.join(p, "view_1_sil.npy"), sil)
        if with_iuv:
            iuv = np.zeros((native, native, 3), np.float32)
            iuv[int(10 * s):int(50 * s), int(20 * s):int(44 * s), 0] = 3
            iuv[int(10 * s):int(50 * s), int(20 * s):int(44 * s), 1:] = \
                rng.uniform(0, 255, (int(40 * s), int(24 * s), 2))
            np.save(os.path.join(p, "view_1_iuv.npy"), iuv)
    # A view with no proxies is left out.
    jio.write_png(os.path.join(image_root, "g1", "s1", "3", "view_2.png"),
                  rng.randint(0, 255, (WH, WH, 3), np.uint8))
    return image_root, proxy_root


def test_collect_proxy_examples_match_jax(proxy_tree):
    got = treal.collect_proxy_examples(*proxy_tree)
    assert got == jreal.collect_proxy_examples(*proxy_tree)
    assert len(got) == 3 and sum("iuv" in r for r in got) == 2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wh", [WH, 2 * WH])
def test_proxy_tree_batches_bit_equal(proxy_tree, seed, wh):
    kw = dict(batch=4, wh=wh, seed=seed)
    got_it = treal.proxy_tree_batches(*proxy_tree, **kw)
    want_it = jreal.proxy_tree_batches(*proxy_tree, **kw)
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["kp_visible"][:, :2] == 0).all()
    assert got["part"].shape == (4, wh // 4, wh // 4)
    one = list(treal.proxy_tree_batches(*proxy_tree, loop=False, **kw))
    assert len(one) == 1
    for k, v in next(jreal.proxy_tree_batches(*proxy_tree, **kw)).items():
        np.testing.assert_array_equal(one[0][k], v, err_msg=k)


def test_empty_tree_yields_nothing(tmp_path):
    os.makedirs(tmp_path / "crops")
    assert list(treal.proxy_tree_batches(str(tmp_path / "crops"),
                                         str(tmp_path), batch=2)) == []


@pytest.mark.parametrize("p_real, n_real", [(0.5, 3), (1.0, 3), (0.3, 50)])
def test_mixed_batches_match_jax(p_real, n_real):
    def run(mod):
        real = iter([{"src": "real", "i": i} for i in range(n_real)])
        mix = mod.mixed_batches(lambda step: {"src": "synth", "step": step},
                                real, p_real=p_real, seed=4)
        return [next(mix) for _ in range(12)]

    got = run(treal)
    assert got == run(jreal)
    assert {b["src"] for b in got} == {"real", "synth"}
    mix = treal.mixed_batches(lambda step: {"src": "synth"}, None, 1.0)
    assert next(mix)["src"] == "synth"


def test_proxynet_step_on_a_real_batch(proxy_tree):
    batch = next(treal.proxy_tree_batches(*proxy_tree, batch=2, wh=WH,
                                          seed=2))
    model = ttrain.new_proxynet(gen=torch.Generator().manual_seed(0),
                                device="cpu")
    assert isinstance(model, ProxyNet)
    state = ttrain.make_perception_state(model, 1e-3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, losses = ttrain.make_proxynet_train_step()(state, tb)
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in losses.values())
    # A crop without IUV labels adds nothing to the part and UV losses.
    tb["iuv_valid"] = torch.zeros(2)
    with torch.no_grad():
        _, no_iuv = ttrain.proxynet_losses(state.model, tb, train=False)
    assert float(no_iuv["part"]) == 0.0 and float(no_iuv["uv"]) == 0.0
