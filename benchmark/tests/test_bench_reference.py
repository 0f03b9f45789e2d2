"""The plain reference against the measured package on the CPU, at
small sizes."""

import numpy as np
import pytest
import torch

from benchmark.reference import fit as ref_fit
from benchmark.reference import frame as ref_frame
from benchmark.reference import nets, predict, silhouette, smpl
from benchmark.harness import REPO
from benchmark.traffic import bodies, broadcast_frames, player_views

from soccerplayershapepose_torch.convert import (  # noqa: E402
    load_detector_weights, load_proxynet_weights, load_regressor_weights)
from soccerplayershapepose_torch.fit.engine import FitConfig, FitInit
from soccerplayershapepose_torch.fit.single_view import single_view_fit
from soccerplayershapepose_torch.pipeline.fullframe import (
    build_frame_pipeline)
from soccerplayershapepose_torch.pipeline.predict import predict_smpl
from soccerplayershapepose_torch.render.softras import (
    cull_backfaces, soft_silhouette)
from soccerplayershapepose_torch.smpl.assets import (
    synthesize_arrays, synthesize_assets)
from soccerplayershapepose_torch.smpl.model import smpl_forward

REG = str(REPO / "weights/regressor_18ch_f16.npz")


@pytest.fixture(scope="module")
def model():
    return smpl.load("cpu")


@pytest.fixture(scope="module")
def bodies4():
    gen = torch.Generator().manual_seed(3)
    return bodies.random_bodies(gen, 4)


def test_smpl_stand_in_and_forward_match(model, bodies4):
    port = synthesize_arrays()
    mine = smpl.synthesize()
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(port[k], v.dtype), v,
                                      err_msg=k)
    body, orient, betas = bodies4
    verts, joints = smpl.forward(model, betas, body, orient)
    out = smpl_forward(synthesize_assets(), betas, body, orient)
    np.testing.assert_allclose(verts, out.vertices, atol=2e-6)
    np.testing.assert_allclose(joints, out.joints, atol=2e-6)


def test_predict_matches(model):
    pool = player_views.make({"pool": 2, "batch": 2, "wh": 512,
                              "render_block": 2, "cam_scale": [0.7, 0.95],
                              "cam_shift": 0.1, "pose_energy": [0.4, 1.5],
                              "betas_scale": 1.5, "keypoint_noise_px": 2.0},
                             11, "cpu")
    sil, j2d = pool["silhouette"], pool["joints2d"]
    assert 0.05 < float(sil.mean()) < 0.5          # a player fills the crop
    w = nets.load_flat(REG, "cpu")
    mine = predict.predict(w, model, sil, j2d, 512)
    port = predict_smpl(load_regressor_weights(REG, device="cpu"),
                        synthesize_assets(), sil, j2d, device="cpu")
    np.testing.assert_allclose(mine.rotmats, port.pose_rotmats, atol=1e-5)
    np.testing.assert_allclose(mine.cam_wp, port.cam_wp, atol=1e-5)
    np.testing.assert_allclose(mine.joints2d, port.joints2d_kprcnn,
                               atol=1e-2)


def test_support_bounded_silhouette_matches_the_dense_one(model, bodies4):
    body, orient, betas = bodies4
    verts, _ = smpl.forward(model, betas, body, orient)
    cam = torch.tensor([[0.9, 0.0, 0.05]]).expand(4, 3)
    v2d = smpl.project(verts, smpl.translation(cam, 48), 48)
    v2d = v2d.clone().requires_grad_(True)
    sigma = 1e-4
    mine = silhouette.soft_silhouette(v2d, model.faces, 48, sigma)
    g = torch.randn(mine.shape, generator=torch.Generator().manual_seed(1))
    (gm,) = torch.autograd.grad((mine * g).sum(), v2d)
    v2 = v2d.detach().clone().requires_grad_(True)
    dense = soft_silhouette(v2, cull_backfaces(v2.detach(), model.faces),
                            48, sigma=sigma)
    (gd,) = torch.autograd.grad((dense * g).sum(), v2)
    np.testing.assert_allclose(mine.detach(), dense.detach(), atol=2e-6)
    scale = float(gd.abs().max())
    np.testing.assert_allclose(gm / scale, gd / scale, atol=1e-4)


def test_fit_trajectory_matches(model):
    pool = player_views.make({"pool": 2, "batch": 2, "wh": 32,
                              "render_block": 2, "cam_scale": [0.7, 0.95],
                              "cam_shift": 0.1, "pose_energy": [0.4, 1.5],
                              "betas_scale": 1.5, "keypoint_noise_px": 0.2},
                             12, "cpu")
    sil, j2d = pool["silhouette"], pool["joints2d"]
    w = nets.load_flat(REG, "cpu")
    p = predict.predict(w, model, sil, j2d, 32)
    traj = ref_fit.fit(model, p.rotmats[:, 1:], p.rotmats[:, :1], p.betas,
                       p.cam_wp, sil, j2d, 2, 3, 1e-3, 1e-5, 32)
    res = single_view_fit(
        synthesize_assets(),
        FitInit(p.rotmats[:, 1:], p.rotmats[:, :1], p.betas, p.cam_wp),
        sil, j2d, FitConfig(iters=3, proxy_wh=32, render_wh=32),
        device="cpu")
    np.testing.assert_array_equal(res.best_iter.numpy(), traj.best_iter)
    rows = torch.arange(2)
    it = traj.best_iter - 1
    np.testing.assert_allclose(res.cam_wp, traj.cam_wp[it, rows],
                               atol=2e-6)
    np.testing.assert_allclose(res.body_pose, traj.body_pose[it, rows],
                               atol=2e-6)
    np.testing.assert_allclose(res.silh_iou, traj.iou[it, rows], atol=1e-6)


def test_frame_pipeline_matches(model):
    pool = broadcast_frames.make({"pool": 1, "players": 3, "height": 64,
                                  "width": 96, "cam_scale": [0.4, 0.6],
                                  "shift_x": 0.5, "shift_y": 0.2,
                                  "frames_per_call": 1}, 4, "cpu")
    frames = pool["frames"]
    assert frames.shape == (1, 64, 96, 3) and frames.dtype == np.float32
    dets = str(REPO / "weights/detector_256x448_f16.npz")
    pn = str(REPO / "weights/proxynet_512_f16.npz")
    fn = build_frame_pipeline(
        load_detector_weights(dets, device="cpu"),
        load_proxynet_weights(pn, device="cpu", with_iuv=False),
        load_regressor_weights(REG, device="cpu"), max_players=4,
        crop_wh=64, device="cpu")
    port = fn(synthesize_assets(), frames)
    mine = ref_frame.run(nets.load_flat(dets, "cpu"),
                         nets.load_flat(pn, "cpu"),
                         nets.load_flat(REG, "cpu"), model,
                         torch.as_tensor(frames), 4, 64, 40)
    np.testing.assert_allclose(mine.boxes, port.boxes, atol=1e-4)
    np.testing.assert_allclose(mine.scores, port.scores, atol=1e-6)
    np.testing.assert_allclose(mine.joints2d, port.joints2d, atol=1e-3)
    np.testing.assert_allclose(mine.vertices, port.vertices, atol=1e-5)
