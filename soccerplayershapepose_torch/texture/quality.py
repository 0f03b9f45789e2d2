"""The texture-from-IUV quality probe.

Counterpart of ``scripts/texture_probe.py`` of the JAX package, as a
function: how much texture quality is lost when the atlas is built from
ProxyNet's predicted IUV instead of the ground truth, on synthetic crops
where the ground-truth IUV is exact. Everything runs at the IUV head's
stride-4 grid (64² for 256² crops): the crops are downsampled to it
(bilinear with antialiasing, as ``jax.image.resize``), the ground truth is
the crop factory's stride-4 part and UV labels, the prediction ProxyNet's
``decode_iuv`` without upsampling.

Metrics, each the mean over the batches (``weights/texture_quality.json``
is the JAX package's record):

* ``gt_roundtrip_psnr_db`` / ``pred_roundtrip_psnr_db``: the atlas from an
  IUV, read back at the same IUV's texels, against the source pixels
  (PSNR over the valid pixels, per crop, then the mean);
* ``pred_vs_gt_l1`` / ``pred_vs_gt_psnr_db``: the predicted atlas against
  the ground-truth atlas on the texels both cover;
* ``coverage_gt``, ``coverage_pred``, ``coverage_inter``: the share of
  atlas texels covered by each and by both.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
from torch.nn import functional as F

from soccerplayershapepose_torch.models.perception import (
    STRIDE, ProxyNet, decode_iuv)
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.texture.uv import (
    fuse_atlas_textures, iuv_to_atlas_texture, texel_index)
from soccerplayershapepose_torch.train.straps import _lap
from soccerplayershapepose_torch.train.synth import (
    render_crop_batch, sample_crop_draws)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

SEED = 77_000_000


def _psnr_db(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-10))


def roundtrip_psnr(images: torch.Tensor, iuv: torch.Tensor) -> torch.Tensor:
    """(B,) PSNR of (B, H, W, 3) ``images`` scattered into their atlases by
    ``iuv`` (B, H, W, 3) and gathered back at the same texels, over each
    crop's valid pixels."""
    b = images.shape[0]
    tex, _ = iuv_to_atlas_texture(images, iuv)
    valid, idx = texel_index(iuv)
    recon = torch.gather(tex.reshape(b, -1, 3), 1,
                         idx.reshape(b, -1, 1).expand(-1, -1, 3))
    w = valid.reshape(b, -1, 1).to(torch.float32)
    err = torch.sum((recon - images.reshape(b, -1, 3)) ** 2 * w, dim=(1, 2)) \
        / torch.clamp(w.sum(dim=(1, 2)) * 3, min=1.0)
    return _psnr_db(err)


def texture_metrics(images: torch.Tensor, iuv_gt: torch.Tensor,
                    iuv_pred: torch.Tensor) -> dict:
    """The probe's seven metrics of one batch, as 0-dim tensors, from
    (B, h, w, 3) images at the IUV grid and the two IUVs."""
    tex_gt, m_gt = iuv_to_atlas_texture(images, iuv_gt)
    tex_pr, m_pr = iuv_to_atlas_texture(images, iuv_pred)
    inter = m_gt * m_pr
    n = torch.clamp(inter.sum() * 3, min=1.0)
    diff = (tex_gt - tex_pr) * inter[..., None]
    mse = torch.sum((tex_gt - tex_pr) ** 2 * inter[..., None]) / n
    return {"gt_roundtrip_psnr_db": roundtrip_psnr(images, iuv_gt).mean(),
            "pred_roundtrip_psnr_db": roundtrip_psnr(images, iuv_pred).mean(),
            "pred_vs_gt_l1": torch.sum(torch.abs(diff)) / n,
            "pred_vs_gt_psnr_db": _psnr_db(mse),
            "coverage_gt": m_gt.mean(),
            "coverage_pred": m_pr.mean(),
            "coverage_inter": inter.mean()}


def downsample(images: torch.Tensor, out_wh: int) -> torch.Tensor:
    """(B, H, W, C) → (B, out_wh, out_wh, C), bilinear with antialiasing
    (``jax.image.resize(..., "linear")``)."""
    return F.interpolate(images.permute(0, 3, 1, 2), size=(out_wh, out_wh),
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


@torch.no_grad()
def texture_quality(proxynet: ProxyNet, assets: SMPLAssets,
                    n_batches: int = 4, batch: int = 16, wh: int = 256,
                    seed: int = SEED,
                    stage_times: Optional[dict] = None,
                    device: DeviceLike = None) -> dict:
    """The probe on ``device`` (None: the CUDA card): ``n_batches`` batches
    of ``batch`` RGB crops at ``wh``² (occluders, domain randomisation),
    ProxyNet ``proxynet`` (with its IUV head, moved to the device) on the
    crops, the atlases from the ground-truth and the predicted IUV. The
    geometry is drawn from a CPU generator seeded with ``seed`` and the
    appearance from one on ``device`` seeded the same. ``stage_times``, a
    dict, receives the wall seconds of ``synthesis``, ``proxynet`` and
    ``scatter`` (the atlases and the metrics). Returns the mean of each
    metric, the run's sizes, and ``pred_atlas`` / ``pred_atlas_mask``: the
    first batch's predicted atlases fused over its crops, (24, R, R, 3)
    and (24, R, R)."""
    if not proxynet.with_iuv:
        raise ValueError("the texture probe needs ProxyNet's IUV head")
    dev = default_device(device)
    assets = on_device(assets, dev)
    proxynet = proxynet.to(dev).eval()
    gen = torch.Generator().manual_seed(seed)
    image_gen = torch.Generator(device=dev).manual_seed(seed)
    grid = wh // STRIDE
    sums: Optional[dict] = None
    fused = None
    n_crops = 0
    t = _lap(stage_times, "synthesis", time.perf_counter(), dev)
    for _ in range(n_batches):
        d = sample_crop_draws(gen, batch, image_wh=wh, image_gen=image_gen)
        data = render_crop_batch(assets, d, wh, with_image=True)
        images = downsample(data["image"], grid)
        iuv_gt = torch.cat([data["part"][..., None].to(torch.float32),
                            data["uv"]], dim=-1)
        t = _lap(stage_times, "synthesis", t, dev)
        out = proxynet(data["image"].permute(0, 3, 1, 2))
        iuv_pred = decode_iuv(out.part_logits, out.uv)
        t = _lap(stage_times, "proxynet", t, dev)
        m = {k: float(v) for k, v in
             texture_metrics(images, iuv_gt, iuv_pred).items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        if fused is None:
            fused = fuse_atlas_textures(
                *iuv_to_atlas_texture(images, iuv_pred))
        n_crops += images.shape[0]
        t = _lap(stage_times, "scatter", t, dev)
    out = {k: v / n_batches for k, v in sums.items()}
    out.update(n_crops=n_crops, wh=wh, grid=grid, pred_atlas=fused[0],
               pred_atlas_mask=fused[1])
    return out
