"""Guards of the PyTorch port: what it imports, what it ships, and how it
refuses to run a kernel path where no kernel can run."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from soccerplayershapepose_torch import _build  # noqa: E402
from soccerplayershapepose_torch.render import attribute as attr  # noqa: E402
from soccerplayershapepose_torch.render import band_raster as br  # noqa: E402
from soccerplayershapepose_torch.render import zbuffer as zb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "soccerplayershapepose_torch")
MAX_FILE_BYTES = 512 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    intra-op threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def body():
    """The synthetic SMPL mesh's template projected into a 32² image, two
    samples (the second mirrored and shifted)."""
    import numpy as np
    from soccerplayershapepose_torch.smpl import synthesize_assets
    a = synthesize_assets()
    v = a.v_template.numpy()
    wh = 32
    v2d = np.stack([v[:, 0] * wh * 0.9 + wh / 2,
                    -v[:, 1] * wh * 0.45 + wh / 2], -1)[None]
    v2d = np.concatenate([v2d, v2d[:, :, ::-1] + 0.3]).astype(np.float32)
    return v2d, a.faces.numpy(), wh

_GUARD = r"""
import importlib, importlib.abc, os, pkgutil, sys
REFUSED = ("jax", "jaxlib", "flax", "optax", "soccerplayershapepose_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, os.getcwd())
import soccerplayershapepose_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def _package_files():
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            yield os.path.join(root, f)


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 29


@pytest.mark.parametrize("needle", ["cpp_extension", "import triton",
                                    "import jax", "from jax",
                                    "soccerplayershapepose_tpu import",
                                    "soccerplayershapepose_tpu."])
def test_port_sources_name_no_forbidden_module(needle):
    paths = [p for p in _package_files() if p.endswith(".py")]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    for p in paths:
        with open(p) as f:
            src = f.read()
        code = "\n".join(line for line in src.splitlines()
                         if not line.lstrip().startswith(("#", "``", "*")))
        if needle.startswith("soccerplayershapepose_tpu"):
            # docstrings cite the JAX counterpart by path; code never does
            assert ("import soccerplayershapepose_tpu" not in code
                    and "from soccerplayershapepose_tpu" not in code), p
        else:
            assert needle not in code, p


def test_package_files_are_small_sources():
    files = list(_package_files())
    assert files
    for p in files:
        assert os.path.getsize(p) <= MAX_FILE_BYTES, p
        assert os.path.splitext(p)[1] in (".py", ".cu", ".cuh"), p


def test_launchers_refuse_cpu_tensors():
    fc = torch.zeros(1, 8, br.REC)
    r = torch.zeros(1, 1, dtype=torch.int32)
    lo = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        br.launch_fwd(fc, r, r, r, r, lo, lo, 32, 0.1, 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        br.launch_bwd(fc, torch.zeros(1, 32, 32), 32, 0.1)
    with pytest.raises(ValueError, match="20"):
        br.launch_fwd(torch.zeros(1, 8, 6), r, r, r, r, lo, lo, 32, 0.1, 3.0)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers compute the plain versions and count no
    launch."""
    tri = torch.tensor([[[2.0, 2.0, 12.0, 3.0, 6.0, 12.0]] * 8])
    fc = br.face_constants(tri, br.support_radius(0.1))
    r = torch.zeros(1, 1, dtype=torch.int32)
    lo = torch.zeros(1, 2, dtype=torch.int32)
    br.reset_launch_counts()
    s = br.band_raster_fwd(fc, r, r, r, r, lo, lo, 16, 0.1, 3.0)
    torch.testing.assert_close(s, br.band_raster_fwd_plain(fc, 16, 0.1))
    d = br.band_raster_bwd(fc, torch.ones(1, 16, 16), 16, 0.1)
    assert d.shape == (1, 8, 6)
    assert br.LAUNCHES == {"band_raster_fwd": 0, "band_raster_bwd": 0}


def test_zbuffer_launcher_refuses_cpu_tensors_and_bad_shapes():
    """K3 takes the (B, F_pad, 20) face records of the sorted table, on the
    card only."""
    zr = zb.face_records(torch.zeros(1, 8, 9))
    lo = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        zb.launch_zbuffer(zr, lo, lo, 32)
    with pytest.raises(ValueError, match="20"):
        zb.launch_zbuffer(torch.zeros(1, 8, 9), lo, lo, 32)
    with pytest.raises(ValueError, match="20"):
        zb.launch_zbuffer(torch.zeros(8, 20), lo, lo, 32)


def test_zbuffer_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K3's wrapper computes the plain version and counts no
    launch; ``rasterize_attributes`` takes the plain oracle."""
    v = torch.tensor([[[2.0, 2.0], [12.0, 3.0], [6.0, 12.0]]])
    z = torch.ones(1, 3)
    faces = torch.tensor([[0, 1, 2]])
    tri9, _, cymin, cymax, _, _, _ = zb._sorted_tri_z_and_ranges(v, z, faces)
    lo, hi = br._band_chunk_bounds(cymin, cymax, 2, br.BAND_H, zb.MARGIN)
    zb.reset_launch_counts()
    fid, w0, w1 = zb.zbuffer_bary(tri9, lo, hi, 16)
    pf, p0, p1 = zb.rasterize_bary_plain(tri9, 16)
    assert torch.equal(fid, pf) and torch.equal(w0, p0) and (fid >= 0).any()
    out, mask = attr.rasterize_attributes(v, z, torch.ones(1, 3, 2), faces, 16)
    assert torch.equal(mask, fid >= 0)
    assert torch.allclose(out[mask], torch.ones(1, 2))
    assert zb.LAUNCHES == {"zbuffer_bary": 0}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_build_command_is_one_plain_nvcc(monkeypatch, tmp_path):
    """One nvcc over csrc/*.cu for sm_90a into a temporary file that
    os.replace moves into the content-hashed directory."""
    calls = []
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)

    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.subprocess, "run", run)
    lib = _build.build()
    assert os.path.basename(lib) == _build.LIB_NAME == "libspt_kernels.so"
    assert os.listdir(os.path.dirname(lib)) == [_build.LIB_NAME]
    (cmd,) = calls
    assert cmd[0] == str(fake)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert [c for c in cmd if c.endswith(".cu")] == _build.sources()
    assert [os.path.basename(c) for c in _build.sources()] == [
        "band_raster.cu", "zbuffer.cu"]
    assert _build.build() == lib and len(calls) == 1     # cached by content


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lone.write_text(f.read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("b,wh,sigma", [(2, 64, 1e-5), (1, 128, 1e-5),
                                        (1, 128, 1e-4)])
def test_kernels_match_plain_on_card(cuda_device, body, b, wh, sigma):
    """K1 ≤ 1e-6 max abs and K2 ≤ 1e-5 relative L2 against the plain
    versions, K2 bit-identical from run to run, each kernel evaluating
    exactly the pairs inside the faces' padded boxes, and one launch
    counted per kernel call."""
    v2d, faces, _ = body
    v = torch.from_numpy(v2d[:b] * (wh / 32.0)).to(cuda_device)
    sigma_px = sigma * (wh / 2.0) ** 2
    margin = br.support_margin(sigma_px)
    args, _ = br.band_inputs(v, torch.from_numpy(faces).to(cuda_device), wh,
                             sigma_px, True)
    fc = args[0]
    br.reset_launch_counts()
    s = br.band_raster_fwd(*args, wh, sigma_px, margin)
    assert (s - br.band_raster_fwd_plain(fc, wh, sigma_px)).abs().max() <= 1e-6
    gs = (torch.randn_like(s) * (1 - s)).contiguous()
    d = br.band_raster_bwd(fc, gs, wh, sigma_px)
    dp = br.band_raster_bwd_plain(fc, gs, wh, sigma_px)
    assert (torch.linalg.vector_norm(d - dp)
            / torch.linalg.vector_norm(dp)).item() <= 1e-5
    assert br.LAUNCHES == {"band_raster_fwd": 1, "band_raster_bwd": 1}
    n1 = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    n2 = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    assert torch.equal(br.launch_fwd(*args, wh, sigma_px, margin,
                                     pair_count=n1), s)
    assert torch.equal(br.launch_bwd(fc, gs, wh, sigma_px, pair_count=n2), d)
    want = br.support_pairs(fc[..., br.BOX], wh)
    assert int(n1) == int(n2) == want > 0


@pytest.mark.cuda
def test_launchers_reject_bad_tensors_on_card(cuda_device, body):
    v2d, faces, wh = body
    v = torch.from_numpy(v2d).to(cuda_device)
    (fc, cymin, cymax, cxmin, cxmax, lo, hi), _ = br.band_inputs(
        v, torch.from_numpy(faces).to(cuda_device), wh, 0.1, True)
    with pytest.raises(TypeError):
        br.launch_fwd(fc.double(), cymin, cymax, cxmin, cxmax, lo, hi, wh,
                      0.1, 3.0)
    with pytest.raises(ValueError):
        br.launch_fwd(fc, cymin, cymax, cxmin, cxmax, lo[:, :2].contiguous(),
                      hi, wh, 0.1, 3.0)
    with pytest.raises(ValueError):
        br.launch_bwd(fc, torch.zeros(2, wh, wh, device=cuda_device
                                      ).transpose(1, 2), wh, 0.1)
    with pytest.raises(ValueError, match="aligned"):
        br.launch_bwd(fc.reshape(-1)[1:1 + fc.numel() - 2 * br.REC].reshape(
            2, -1, br.REC), torch.zeros(2, wh, wh, device=cuda_device), wh,
            0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,wh", [(2, 32), (1, 128)])
def test_zbuffer_kernel_matches_plain_on_card(cuda_device, body, b, wh):
    """K3 against its plain version: face ids and mask identical, w ≤ 1e-6
    max abs, one launch counted, the same result from run to run, and
    exactly the pairs inside the faces' padded boxes evaluated."""
    v2d, faces, _ = body
    v = torch.from_numpy(v2d[:b] * (wh / 32.0)).to(cuda_device)
    z = (v[..., 0] * 0.01 + 5.0).contiguous()
    tri9, _, cymin, cymax, _, _, _ = zb._sorted_tri_z_and_ranges(
        v, z, torch.from_numpy(faces).to(cuda_device))
    lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                   br.BAND_H, zb.MARGIN)
    zb.reset_launch_counts()
    fid, w0, w1 = zb.zbuffer_bary(tri9, lo, hi, wh)
    pf, p0, p1 = zb.rasterize_bary_plain(tri9, wh)
    assert torch.equal(fid, pf) and (fid >= 0).any()
    assert (w0 - p0).abs().max() <= 1e-6 and (w1 - p1).abs().max() <= 1e-6
    assert zb.LAUNCHES == {"zbuffer_bary": 1}
    # The counting launch evaluates exactly the pairs inside the padded
    # boxes, and the order-free winner repeats bit for bit.
    zr = zb.face_records(tri9)
    n = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    again = zb.launch_zbuffer(zr, lo, hi, wh, pair_count=n)
    assert all(torch.equal(a, b) for a, b in zip(again, (fid, w0, w1)))
    assert int(n) == br.support_pairs(zr[..., zb.BOX], wh)


@pytest.mark.cuda
def test_rgb_crops_and_extraction_repeat_on_card(cuda_device):
    """The RGB crop branch (K3 with colour channels, the shading's vertex
    normals gathered in a fixed order) and the extractor's forward give
    the same bits from run to run on the card, with K3 launched twice per
    crop batch."""
    from soccerplayershapepose_torch.convert import load_proxynet_weights
    from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import straps, synth
    assets = synthesize_assets(device=cuda_device)
    draws = synth.sample_crop_draws(
        torch.Generator().manual_seed(0), 4, image_wh=256,
        image_gen=torch.Generator(device=cuda_device).manual_seed(0))
    zb.reset_launch_counts()
    first = synth.render_crop_batch(assets, draws, 256, with_image=True)
    assert zb.LAUNCHES == {"zbuffer_bary": 2}
    again = synth.render_crop_batch(assets, draws, 256, with_image=True)
    for k, v in first.items():
        assert torch.equal(v, again[k]), k
    ex = ProxyExtractor(load_proxynet_weights(
        os.path.join(REPO, "weights", "proxynet_256_f16.npz"), cuda_device),
        wh=256, device=cuda_device)
    images = straps.crop_images_u8(first["image"])
    for a, b in zip(ex.forward(images), ex.forward(images)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_frames_and_frame_pipeline_repeat_on_card(cuda_device):
    """Synthetic frames (all players of a frame in one K3 pass, launched
    once per batch) and the full-frame pipeline give the same bits from
    run to run on the card."""
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.pipeline.fullframe import (
        build_frame_pipeline)
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import synth
    assets = synthesize_assets(device=cuda_device)
    hw = (256, 448)
    draws = synth.sample_frame_draws(
        torch.Generator().manual_seed(0), 2, 8, hw,
        image_gen=torch.Generator(device=cuda_device).manual_seed(0))
    zb.reset_launch_counts()
    first = synth.render_frame_batch(assets, draws, hw)
    assert zb.LAUNCHES == {"zbuffer_bary": 1}
    again = synth.render_frame_batch(assets, draws, hw)
    for k, v in first.items():
        assert torch.equal(v, again[k]), k
    weights = os.path.join(REPO, "weights")
    fn = build_frame_pipeline(
        convert.load_detector_weights(
            os.path.join(weights, "detector_256x448_f16.npz"), cuda_device),
        convert.load_proxynet_weights(
            os.path.join(weights, "proxynet_256_f16.npz"), cuda_device,
            with_iuv=False),
        convert.load_regressor_weights(
            os.path.join(weights, "regressor_18ch_f16.npz"), cuda_device),
        max_players=6, crop_wh=256, device=cuda_device)
    a, b = fn(assets, first["image"]), fn(assets, first["image"])
    assert a.vertices.shape == (2, 6, 6890, 3) and bool(a.valid.any())
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
