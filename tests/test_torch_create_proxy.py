"""The port's ``create_proxy_stage`` (``pipeline/extract.py``) against the
JAX package's, on the committed ``weights/proxynet_256_f16.npz`` at 256²
(the weights find nobody below 256², ROADMAP.md §3), with flip TTA.

The crop tree (``test_torch_extract.crops``: three synthetic RGB crops
and one of plain grass) holds player 1 (skipped, the camera-man crop),
player 2 (two crops; view0's proxy exists already, so ``skip_existing``
leaves it out) and player 3 (a crop, then the grass, where extraction
fails): player 3's first view is written, then the whole player is
deleted, on both sides. Batches of 2, so the last one is padded.

The same files are written on both sides; the written joints agree with
the extractor bars of tests/test_torch_extract.py (1e-3 px, scores 1e-6;
this crop has no heatmap near-tie), the silhouettes and IUV part ids
differ at no more than 0.1% of their pixels, U and V within 1e-2 on
their 0-255 scale elsewhere; the overlays are (256, 256, 3).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_tpu.models.perception import (  # noqa: E402
    ProxyNet as JProxyNet)
from soccerplayershapepose_tpu.pipeline import extract as jextract  # noqa

from soccerplayershapepose_torch.pipeline import extract as textract  # noqa
from soccerplayershapepose_torch.pipeline.densepose import (  # noqa: E402
    decode_png, encode_png)

from test_torch_extract import (  # noqa: E402,F401
    KP_TOL, SCORE_TOL, SIL_FRAC, UV_TOL, WH, crops, jax_variables, port_net)
from test_torch_scene_tree import tree_files  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crop_tree(root, crops):
    layout = {"1": [crops[0]], "2": [crops[1], crops[2]],
              "3": [crops[0], crops[3]]}
    for player, imgs in layout.items():
        d = os.path.join(root, "g1", "s1", player)
        os.makedirs(d)
        for v, img in enumerate(imgs):
            with open(os.path.join(d, f"view{v}.png"), "wb") as f:
                f.write(encode_png(img))


def test_create_proxy_stage_matches_jax(tmp_path, crops, jax_variables,
                                        port_net):
    images = str(tmp_path / "images")
    _crop_tree(images, crops)
    np.testing.assert_array_equal(
        textract.read_image(os.path.join(images, "g1/s1/2/view1.png"), WH),
        jextract.read_image(os.path.join(images, "g1/s1/2/view1.png"), WH))
    extractors = {
        "j": jextract.ProxyExtractor(JProxyNet(), jax_variables, wh=WH,
                                     flip_tta=True),
        "t": textract.ProxyExtractor(port_net, wh=WH, flip_tta=True,
                                     device="cpu")}
    stage = {"j": jextract.create_proxy_stage,
             "t": textract.create_proxy_stage}
    out = {}
    for side in ("j", "t"):
        pre = tmp_path / side / "g1" / "s1" / "2"
        os.makedirs(pre)
        np.save(pre / "view0_sil.npy", np.zeros((WH, WH), np.uint8))
        with open(pre / "view0_j2d.xml", "w") as f:
            json.dump(np.zeros((17, 3)).tolist(), f)
        out[side] = stage[side](extractors[side], images,
                                str(tmp_path / side),
                                vis_root=str(tmp_path / (side + "vis")),
                                batch_size=2, write_iuv=True)
    assert out["t"] == out["j"] == {"written": 2,
                                    "failed_players": ["g1/s1/3"]}
    files = tree_files(tmp_path / "j")
    assert files == tree_files(tmp_path / "t") == [
        "g1/s1/2/view0_j2d.xml", "g1/s1/2/view0_sil.npy",
        "g1/s1/2/view1_iuv.npy", "g1/s1/2/view1_j2d.xml",
        "g1/s1/2/view1_sil.npy"]
    stem = "g1/s1/2/view1"
    with open(tmp_path / "t" / (stem + "_j2d.xml")) as f:
        kp = np.array(json.load(f))
    with open(tmp_path / "j" / (stem + "_j2d.xml")) as f:
        jkp = np.array(json.load(f))
    # No heatmap of this crop has a near-tie (tests/test_torch_extract.py
    # counts them on the same crops), so every joint is held.
    np.testing.assert_allclose(kp[:, :2], jkp[:, :2], rtol=0, atol=KP_TOL)
    np.testing.assert_allclose(kp[:, 2], jkp[:, 2], rtol=0, atol=SCORE_TOL)
    sil = np.load(tmp_path / "t" / (stem + "_sil.npy"))
    jsil = np.load(tmp_path / "j" / (stem + "_sil.npy"))
    assert sil.dtype == jsil.dtype == np.uint8 and sil.shape == (WH, WH)
    assert np.mean(sil != jsil) <= SIL_FRAC
    assert sil.sum() > 100
    iuv = np.load(tmp_path / "t" / (stem + "_iuv.npy"))
    jiuv = np.load(tmp_path / "j" / (stem + "_iuv.npy"))
    assert iuv.shape == jiuv.shape == (WH, WH, 3)
    part_apart = iuv[..., 0] != jiuv[..., 0]
    assert part_apart.mean() <= SIL_FRAC
    np.testing.assert_allclose(iuv[..., 1:][~part_apart],
                               jiuv[..., 1:][~part_apart], rtol=0,
                               atol=UV_TOL)
    vis = tree_files(tmp_path / "tvis")
    assert vis == tree_files(tmp_path / "jvis") == [
        "g1/s1/2/view1_silhouette.png", "g1/s1/3/view0_silhouette.png"]
    with open(tmp_path / "tvis" / vis[0], "rb") as f:
        assert decode_png(f.read()).shape == (WH, WH, 3)
