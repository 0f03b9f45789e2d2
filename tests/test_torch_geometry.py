"""The port's constants, rotations, cameras and SMPL against the JAX package.

Inputs come from numpy seeds and go through both packages. fp32 tolerances:
1e-5 absolute on O(1) geometry (the two frameworks sum the contractions in
another order), 1e-5 relative L2 on gradients.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu import config as jcfg  # noqa: E402
from soccerplayershapepose_tpu.ops import camera as jcam  # noqa: E402
from soccerplayershapepose_tpu.ops import rotations as jrot  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.smpl import model as jmodel  # noqa: E402

from soccerplayershapepose_torch import config as tcfg  # noqa: E402
from soccerplayershapepose_torch.convert import assets_from_numpy  # noqa: E402
from soccerplayershapepose_torch.ops import camera as tcam  # noqa: E402
from soccerplayershapepose_torch.ops import rotations as trot  # noqa: E402
from soccerplayershapepose_torch.smpl import assets as tassets  # noqa: E402
from soccerplayershapepose_torch.smpl import model as tmodel  # noqa: E402
from soccerplayershapepose_torch.utils.precision import default_device  # noqa: E402

ATOL = 1e-5
CONSTANTS = sorted(n for n in vars(tcfg) if n.isupper())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def assets_pair():
    ja = jassets.synthesize_assets()
    ta = assets_from_numpy({k: np.asarray(v)
                            for k, v in dataclasses.asdict(ja).items()})
    return ja, ta


def _pose(rng, b, scale=0.3):
    aa = rng.randn(b, 24, 3).astype(np.float32) * scale
    rot = np.array(jrot.batch_rodrigues(jnp.asarray(aa)))
    betas = rng.randn(b, 10).astype(np.float32)
    cam = np.stack([rng.uniform(0.7, 1.1, b), rng.randn(b) * 0.05,
                    rng.randn(b) * 0.05], -1).astype(np.float32)
    return aa, rot, betas, cam


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_jax(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


def test_precision_pins_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_cpu_and_missing_cuda(monkeypatch):
    assert default_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device("cuda")


def test_batch_rodrigues_matches_jax():
    aa = np.random.RandomState(0).randn(4, 24, 3).astype(np.float32)
    aa[0, 0] = 0.0                                   # the smooth θ→0 branch
    want = np.asarray(jrot.batch_rodrigues(jnp.asarray(aa)))
    got = trot.batch_rodrigues(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rot6d_to_rotmat_matches_jax():
    x = np.random.RandomState(1).randn(5, 24, 6).astype(np.float32)
    want = np.asarray(jrot.rot6d_to_rotmat(jnp.asarray(x)))
    got = trot.rot6d_to_rotmat(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cameras_match_jax():
    rng = np.random.RandomState(2)
    pts = (rng.randn(3, 50, 3) * 0.5).astype(np.float32)
    cam = np.stack([rng.uniform(0.7, 1.1, 3), rng.randn(3) * 0.1,
                    rng.randn(3) * 0.1], -1).astype(np.float32)
    np.testing.assert_allclose(
        tcam.orthographic_project(torch.from_numpy(pts),
                                  torch.from_numpy(cam)).numpy(),
        np.asarray(jcam.orthographic_project(jnp.asarray(pts),
                                             jnp.asarray(cam))), atol=ATOL)
    jt = np.array(jcam.weak_perspective_to_translation(
        jnp.asarray(cam), 5000.0, 512))
    tt = tcam.weak_perspective_to_translation(torch.from_numpy(cam), 5000.0,
                                              512).numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    rot = np.array(jrot.batch_rodrigues(jnp.asarray(
        rng.randn(3, 3).astype(np.float32) * 0.2)))
    for r in (None, rot):
        want = np.asarray(jcam.perspective_project(
            jnp.asarray(pts), None if r is None else jnp.asarray(r),
            jnp.asarray(jt), focal_length=5000.0, img_wh=512))
        got = tcam.perspective_project(
            torch.from_numpy(pts), None if r is None else torch.from_numpy(r),
            torch.from_numpy(tt), focal_length=5000.0, img_wh=512).numpy()
        # pixel coordinates ~O(100): 1e-5 relative
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    kp = rng.uniform(-1, 1, (3, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.undo_keypoint_normalisation(torch.from_numpy(kp), 512).numpy(),
        np.asarray(jcam.undo_keypoint_normalisation(jnp.asarray(kp), 512)),
        rtol=1e-7)


def test_synthesize_assets_identical(assets_pair):
    ja, _ = assets_pair
    ta = tassets.synthesize_assets()
    for f in dataclasses.fields(ta):
        want = np.asarray(getattr(ja, f.name))
        got = getattr(ta, f.name)
        got = np.asarray(got) if f.name == "parents" else got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_load_assets_npz_branch_matches_jax(tmp_path, assets_pair):
    """A real-format SMPL npz (posedirs (V, 3, 207), kintree_table, f)."""
    ja, _ = assets_pair
    v = tcfg.NUM_VERTS
    np.savez(tmp_path / "SMPL_NEUTRAL.npz",
             v_template=np.asarray(ja.v_template) + 0.01,
             shapedirs=np.asarray(ja.shapedirs),
             posedirs=np.asarray(ja.posedirs).T.reshape(v, 3, -1),
             J_regressor=np.asarray(ja.j_regressor),
             weights=np.asarray(ja.lbs_weights),
             f=np.asarray(ja.faces),
             kintree_table=np.stack([np.array(tcfg.SMPL_PARENTS),
                                     np.arange(24)]))
    np.save(tmp_path / "J_regressor_h36m.npy",
            np.asarray(ja.j_regressor_h36m)[::-1].copy())
    want = jassets.load_assets(str(tmp_path), extra_regressor_dir=str(tmp_path))
    got = tassets.load_assets(str(tmp_path), extra_regressor_dir=str(tmp_path))
    for f in dataclasses.fields(got):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name)
        g = np.asarray(g) if f.name == "parents" else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    # no model dir: the synthetic stand-in
    assert tassets.load_assets(None).faces.shape == (tcfg.NUM_FACES, 3)


@pytest.mark.parametrize("pose2rot", [False, True])
def test_smpl_forward_matches_jax(assets_pair, pose2rot):
    ja, ta = assets_pair
    aa, rot, betas, _ = _pose(np.random.RandomState(3), 3)
    transl = np.random.RandomState(4).randn(3, 3).astype(np.float32)
    if pose2rot:
        bp, go = aa[:, 1:], aa[:, :1]
    else:
        bp, go = rot[:, 1:], rot[:, :1]
    want = jmodel.smpl_forward(ja, jnp.asarray(betas), jnp.asarray(bp),
                               jnp.asarray(go), jnp.asarray(transl),
                               pose2rot=pose2rot)
    got = tmodel.smpl_forward(ta, torch.from_numpy(betas), torch.from_numpy(bp),
                              torch.from_numpy(go), torch.from_numpy(transl),
                              pose2rot=pose2rot)
    for name in ("vertices", "joints", "kin_joints", "v_shaped"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    assert got.joints.shape == (3, tcfg.NUM_ALL_JOINTS, 3)


def test_smpl_shape_only_matches_jax(assets_pair):
    ja, ta = assets_pair
    betas = np.random.RandomState(5).randn(2, 10).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.smpl_shape_only(ta, torch.from_numpy(betas)).numpy(),
        np.asarray(jmodel.smpl_shape_only(ja, jnp.asarray(betas))), atol=ATOL)


def test_smpl_gradients_match_jax(assets_pair):
    """jax.grad vs autograd of a projected-joint and vertex objective with
    respect to betas, the free 3×3 rotmats and the camera."""
    ja, ta = assets_pair
    rng = np.random.RandomState(6)
    _, rot, betas, cam = _pose(rng, 2)
    wj = rng.randn(2, tcfg.NUM_ALL_JOINTS, 2).astype(np.float32)
    wv = rng.randn(2, tcfg.NUM_VERTS, 3).astype(np.float32)

    def jloss(betas, rot, cam):
        out = jmodel.smpl_forward(ja, betas, rot[:, 1:], rot[:, :1])
        j2d = jcam.orthographic_project(out.joints, cam)
        return jnp.sum(j2d * wj) + jnp.sum(out.vertices * wv)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(betas), jnp.asarray(rot), jnp.asarray(cam))
    tb, tr, tc = (torch.tensor(x, requires_grad=True)
                  for x in (betas, rot, cam))
    out = tmodel.smpl_forward(ta, tb, tr[:, 1:], tr[:, :1])
    loss = torch.sum(tcam.orthographic_project(out.joints, tc)
                     * torch.from_numpy(wj)) \
        + torch.sum(out.vertices * torch.from_numpy(wv))
    got = torch.autograd.grad(loss, (tb, tr, tc))
    for g, w, name in zip(got, want, ("betas", "rotmats", "cam")):
        assert _rel(g.numpy(), np.asarray(w)) < 1e-5, name
