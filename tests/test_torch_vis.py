"""The port's visualisation renders (``render/vis.py`` and
``pipeline/extract.py:_proxy_vis``) against the JAX package's, at 64².

``render_mesh_overlay`` tints the pixels whose dense soft coverage (σ =
1e-6) exceeds 0.5: on the same vertices the uint8 images are equal except
at pixels whose coverage lies within 1e-6 of 0.5 on either side (the two
frameworks' coverage differs by fp32 rounding there), which are counted.
The keypoint stamps and the proxy overlays are exact. The single-view
stage's ``vis_folder`` writes one decodable ``<view>_1.png`` per view,
as JAX does.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu.drivers import stages as jst  # noqa: E402
from soccerplayershapepose_tpu.ops import camera as jcam  # noqa: E402
from soccerplayershapepose_tpu.pipeline import extract as jextract  # noqa
from soccerplayershapepose_tpu.render import softras as jsr  # noqa: E402
from soccerplayershapepose_tpu.render import vis as jvis  # noqa: E402

from soccerplayershapepose_torch.drivers import stages as tst  # noqa: E402
from soccerplayershapepose_torch.pipeline import extract as textract  # noqa
from soccerplayershapepose_torch.pipeline.densepose import (  # noqa: E402
    decode_png)
from soccerplayershapepose_torch.render import vis as tvis  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.smpl.model import smpl_forward  # noqa: E402

from test_torch_scene_tree import tree_files  # noqa: E402
from test_torch_stages import (  # noqa: E402,F401
    BATCH, fit_configs, runtime, tree)

WH = 64
COVER_TIE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cam", [(0.9, 0.0, 0.0), (0.6, 0.2, -0.1)])
def test_render_mesh_overlay_matches_jax(cam):
    assets = synthesize_assets()
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (WH, WH, 3), np.uint8)
    rot = torch.eye(3).expand(1, 24, 3, 3).clone()
    rot[:, 0] = torch.diag(torch.tensor([1.0, -1.0, -1.0]))
    verts = smpl_forward(assets, torch.from_numpy(
        rng.randn(1, 10).astype(np.float32) * 0.5), rot[:, 1:],
        rot[:, :1]).vertices[0]
    cam_wp = torch.tensor(cam)
    got = tvis.render_mesh_overlay(verts, assets.faces, cam_wp, image)
    want = jvis.render_mesh_overlay(jnp.asarray(verts.numpy()),
                                    jnp.asarray(assets.faces.numpy()),
                                    jnp.asarray(cam_wp.numpy()), image)
    assert got.dtype == np.uint8 and got.shape == (WH, WH, 3)
    v2d = jcam.undo_keypoint_normalisation(jcam.orthographic_project(
        jnp.asarray(verts.numpy())[None], jnp.asarray(cam_wp.numpy())[None]),
        WH)
    cover = np.asarray(jsr.soft_silhouette(
        v2d, jnp.asarray(assets.faces.numpy()), WH, sigma=1e-6))[0]
    apart = (got != want).any(-1)
    ties = np.abs(cover - 0.5) <= COVER_TIE
    print("overlay pixels apart: %d (coverage near-ties %d), tinted %d"
          % (apart.sum(), ties.sum(), (cover > 0.5).sum()))
    assert not (apart & ~ties).any()
    assert (cover > 0.5).sum() > 50
    assert (got != image).any()


def test_keypoint_stamps_and_proxy_vis_match_jax():
    rng = np.random.RandomState(1)
    sil = (rng.rand(WH, WH) > 0.5).astype(np.float32)
    # Joints inside, on the border and outside the image.
    j2d = np.concatenate([rng.uniform(-5, WH + 5, (17, 2)),
                          rng.rand(17, 1)], -1).astype(np.float32)
    image = rng.randint(0, 255, (WH, WH, 3), np.uint8)
    np.testing.assert_array_equal(tvis.draw_keypoints(image, j2d),
                                  jvis.draw_keypoints(image, j2d))
    np.testing.assert_array_equal(
        tvis.draw_keypoints(image, j2d, radius=1, color=(9, 8, 7)),
        jvis.draw_keypoints(image, j2d, radius=1, color=(9, 8, 7)))
    np.testing.assert_array_equal(tvis.proxy_vis(sil, j2d),
                                  jvis.proxy_vis(sil, j2d))
    np.testing.assert_array_equal(textract._proxy_vis(image, sil, j2d),
                                  jextract._proxy_vis(image, sil, j2d))


def test_single_view_vis_folder_matches_jax(tmp_path, tree, runtime):
    ja, jvars, jfn, ta, tfn = runtime
    jc, tc = fit_configs(iters=1)
    for side, run in (("j", lambda out, vis: jst.single_view_optimization(
            ja, tree["img"], tree["prx"], out, params=jvars,
            regressor_fn=jfn, fit_cfg=jc, batch_size=BATCH, verbose=False,
            vis_folder=vis)),
            ("t", lambda out, vis: tst.single_view_optimization(
                ta, tree["img"], tree["prx"], out, regressor_fn=tfn,
                fit_cfg=tc, batch_size=BATCH, verbose=False, vis_folder=vis,
                device="cpu"))):
        run(str(tmp_path / side), str(tmp_path / (side + "vis")))
    files = tree_files(tmp_path / "jvis")
    assert files == tree_files(tmp_path / "tvis")
    assert files == ["g1/s1/2/view0_1.png", "g1/s1/2/view1_1.png",
                     "g1/s1/3/view0_1.png", "g1/s1/3/view1_1.png"]
    for f in files:
        with open(os.path.join(tmp_path, "tvis", f), "rb") as fh:
            got = decode_png(fh.read())
        with open(os.path.join(tmp_path, "jvis", f), "rb") as fh:
            want = decode_png(fh.read())
        assert got.shape == (WH, WH, 3)
        # The fits agree within 1e-5, so the tinted pixels may differ at
        # a few boundary pixels (0 measured).
        apart = (got != want).any(-1).sum()
        print(f, "pixels apart:", apart)
        assert apart <= 0.01 * WH * WH
        # The blue tint over the grey proxy silhouette.
        assert (got[..., 2] > got[..., 0]).any()
