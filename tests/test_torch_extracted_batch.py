"""The port's extracted regressor batches
(``train/straps.py:extracted_regressor_batch`` with ``return_raw``, and
``assemble_extracted_batch``) against the JAX package's, on the draws of
JAX's key stream.

The extractor is a stub that finds nobody in some rows and gives seeded
keypoints, silhouettes and IUV in the others, the same in both packages,
so the rows test both branches: extracted outputs taken as they are, and
the fall-back to the clean labels corrupted by the corruption draws (and
the ground-truth IUV under that silhouette). Both packages render their
64² crops through K3's PyTorch mirror (``test_torch_e2e_eval.fast_raster``;
the dense rasterizers are held against each other in
``tests/test_torch_synth_rgb.py``).

* the raw arrays: the float ones (keypoints, joints, pose, betas, camera)
  within 1e-5, absolute and relative (the joints are 512² pixels: a few
  ulps there are 6e-5 px); the uint8 silhouettes and IUV equal but where SMPL's fp32
  ulps between the frameworks move an edge pixel into or out of a body,
  or a value across a level (counted and printed; at most SIL_FRAC of the
  values); the uint8 crops handed to the extractor likewise;
* ``assemble_extracted_batch`` of JAX's raw arrays in both packages: the
  proxy and every field within 1e-5, at 18 and 21 channels;
* the port's own batch (``return_raw=False``) equals its assembly of its
  raw form (within 1e-5; at 21 channels the IUV within the raw form's
  uint8 quantisation, 1/255).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import straps as jstraps  # noqa: E402

from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import straps as tstraps  # noqa: E402

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401
from test_torch_fit3d import jax_corruption_draws  # noqa: E402
from test_torch_synth_rgb import jax_rgb_crop_draws  # noqa: E402

B, WH = 4, 64
FAIL_ROWS = (1, 3)
TOL = 1e-5
SIL_FRAC = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubExtractor:
    """Finds nobody in ``FAIL_ROWS``; elsewhere seeded keypoints (17, 3),
    a box silhouette (wh, wh) uint8 and a part-3 IUV (wh, wh, 3) uint8.
    Keeps the uint8 crops it was given."""

    device = torch.device("cpu")

    def __init__(self):
        self.images = []

    def __call__(self, images_u8):
        images = np.asarray(images_u8)
        self.images.append(images)
        out = []
        for j in range(images.shape[0]):
            if j in FAIL_ROWS:
                out.append((None, None, None))
                continue
            rs = np.random.RandomState(j)
            kp = np.concatenate([rs.uniform(5, WH - 5, (17, 2)),
                                 rs.uniform(0, 1, (17, 1))], -1)
            sil = np.zeros((WH, WH), np.uint8)
            sil[10 + j:50, 20:40 + j] = 1
            iuv = np.zeros((WH, WH, 3), np.uint8)
            iuv[sil > 0] = (3, 40 * j, 200 - 10 * j)
            out.append((kp.astype(np.float32), sil, iuv))
        return out


def jax_extracted_draws(key, b, wh):
    """The draws of ``jstraps.extracted_regressor_batch(assets, ex, key, b,
    wh)``: its crops' and its fall-back corruption's."""
    k_synth, k_corrupt = jax.random.split(key)
    return tstraps.ExtractedDraws(jax_rgb_crop_draws(k_synth, b, wh),
                                  jax_corruption_draws(k_corrupt, b, wh,
                                                       tstraps.DROP_P))


def _apart(got, want, what):
    """Values of two uint8 arrays apart: counted and printed, at most
    SIL_FRAC of the values."""
    diff = np.abs(got.astype(int) - want.astype(int))
    n = int((diff > 0).sum())
    print("%s: %d of %d values apart (largest gap %d levels)"
          % (what, n, diff.size, diff.max()))
    assert n <= SIL_FRAC * diff.size, (what, n)


@pytest.fixture(scope="module")
def both_assets():
    return jassets.synthesize_assets(), synthesize_assets()


@pytest.mark.parametrize("channels", [18, 21])
def test_extracted_raw_and_assembly_match_jax(fast_raster, both_assets,
                                              channels):
    ja, ta = both_assets
    key = jax.random.PRNGKey(17 + channels)
    jstub, tstub = StubExtractor(), StubExtractor()
    want = jstraps.extracted_regressor_batch(
        ja, jstub, key, b=B, wh=WH, proxy_channels=channels,
        return_raw=True)
    got = tstraps.extracted_regressor_batch(
        ta, tstub, jax_extracted_draws(key, B, WH), wh=WH,
        proxy_channels=channels, return_raw=True)
    assert set(got) == set(want)
    _apart(tstub.images[0], jstub.images[0], "uint8 crops")
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if w.dtype == np.uint8:
            _apart(got[k], w, k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=k)
    # The failed rows carry the corrupted labels (a dropped joint moves off
    # the frame), the others the stub's outputs.
    assert (got["kps"][list(FAIL_ROWS)] < 0).any() or \
        (got["sil"][list(FAIL_ROWS)] > 0).any()
    np.testing.assert_array_equal(got["sil"][0], tstub(np.zeros(
        (1, WH, WH, 3), np.uint8))[0][1])

    # Assembly of the same raw arrays in both packages.
    want_b = jstraps.assemble_extracted_batch(want, WH, channels)
    got_b = tstraps.assemble_extracted_batch(want, WH, channels,
                                             device="cpu")
    assert set(got_b) == set(want_b)
    proxy_j = np.asarray(want_b["proxy"])
    assert got_b["proxy"].shape == (B, channels) + proxy_j.shape[1:3]
    np.testing.assert_allclose(got_b["proxy"].permute(0, 2, 3, 1).numpy(),
                               proxy_j, rtol=0, atol=TOL)
    for k in ("joints2d", "target_pose", "target_betas", "gt_cam_wp"):
        np.testing.assert_allclose(got_b[k].numpy(), np.asarray(want_b[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)

    # The port's own batch is its assembly of its raw form.
    direct = tstraps.extracted_regressor_batch(
        ta, StubExtractor(), jax_extracted_draws(key, B, WH), wh=WH,
        proxy_channels=channels)
    again = tstraps.assemble_extracted_batch(got, WH, channels,
                                             device="cpu")
    # The raw IUV is quantised to uint8: a fall-back row's ground-truth
    # IUV moves by up to one level (1/255).
    proxy_tol = TOL if channels == 18 else 1 / 255 + TOL
    for k, v in again.items():
        np.testing.assert_allclose(direct[k].numpy(), v.numpy(), rtol=0,
                                   atol=proxy_tol if k == "proxy" else 0,
                                   err_msg=k)


def test_sampled_draws_make_a_batch(both_assets):
    """The port's own sampler: shapes and the proxy's channels."""
    _, ta = both_assets
    draws = tstraps.sample_extracted_draws(torch.Generator().manual_seed(0),
                                           2, WH)
    assert draws.crop.appearance is not None
    out = tstraps.extracted_regressor_batch(ta, StubExtractor(), draws,
                                            wh=WH)
    assert out["proxy"].shape == (2, 18, 256, 256)
    assert out["target_pose"].shape == (2, 24, 3, 3)
    assert torch.isfinite(out["proxy"]).all()
