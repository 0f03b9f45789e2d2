"""The port's binding of the native host dataplane (``io/native.py``)
against the JAX package's binding of the same ``native/libdataplane.so``,
and against its own pure-Python path (the library taken away): the same
manifests, the same float32 arrays, the same missing-file error. Mirrors
tests/test_native.py.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from soccerplayershapepose_tpu.io import native as jnative  # noqa: E402

from soccerplayershapepose_torch.io import native as tnative  # noqa: E402


@pytest.fixture(params=["native", "python"])
def port(request, monkeypatch):
    """The port's binding, through the library or through its Python
    path."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        assert not tnative.native_available()
    return tnative


def _dataset(tmp_path, wh=64):
    rng = np.random.RandomState(0)
    stems = []
    for player in ("2", "3"):
        d = tmp_path / "g1" / "s1" / player
        os.makedirs(d)
        for v in (1, 2):
            stem = str(d / f"view_{v}")
            np.save(stem + "_sil.npy",
                    (rng.rand(wh, wh) > 0.5).astype(np.uint8))
            with open(stem + "_j2d.xml", "w") as f:
                json.dump(rng.uniform(0, 512, (17, 3)).round(3).tolist(), f)
            stems.append(stem)
    (tmp_path / "g1" / "notes.txt").write_text("x")
    return stems


def test_native_library_loads_in_both_bindings():
    assert tnative.native_available() and jnative.native_available()
    assert tnative.LIB_PATH == jnative._LIB_PATH


@pytest.mark.parametrize("suffix", ["_sil.npy", "", ".xml", ".none"])
def test_scan_tree_matches_jax(tmp_path, port, suffix):
    _dataset(tmp_path)
    got = port.scan_tree(str(tmp_path), suffix)
    assert got == jnative.scan_tree(str(tmp_path), suffix)
    if suffix == "_sil.npy":
        assert got == ["g1/s1/2/view_1_sil.npy", "g1/s1/2/view_2_sil.npy",
                       "g1/s1/3/view_1_sil.npy", "g1/s1/3/view_2_sil.npy"]


def test_load_npy_f32_matches_jax(tmp_path, port):
    rng = np.random.RandomState(1)
    for arr in [(rng.rand(16, 8) * 255).astype(np.uint8),
                rng.rand(8, 16).astype(np.float32),
                rng.rand(4, 4),
                np.arange(12, dtype=np.int64).reshape(3, 4),
                np.arange(6, dtype=np.int32).reshape(2, 3),
                rng.rand(2, 3, 4).astype(np.float32)]:
        p = str(tmp_path / "a.npy")
        np.save(p, arr)
        got = port.load_npy_f32(p)
        want = jnative.load_npy_f32(p)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr.astype(np.float32))


def test_load_proxy_batch_matches_jax(tmp_path, port):
    stems = _dataset(tmp_path)
    sil, j2d = port.load_proxy_batch(stems, wh=64, n_threads=2)
    want_sil, want_j2d = jnative.load_proxy_batch(stems, wh=64, n_threads=2)
    assert sil.dtype == j2d.dtype == np.float32
    assert sil.shape == (4, 64, 64) and j2d.shape == (4, 17, 3)
    np.testing.assert_array_equal(sil, want_sil)
    # The native JSON parser and json.load round the same decimals to
    # float32 (3 digits after the point).
    np.testing.assert_allclose(j2d, want_j2d, rtol=0, atol=1e-4)


def test_load_proxy_batch_missing_file_errors(tmp_path, port):
    stems = _dataset(tmp_path)
    with pytest.raises(IOError):
        port.load_proxy_batch(stems + [str(tmp_path / "missing")], wh=64)
    with pytest.raises(IOError):
        jnative.load_proxy_batch(stems + [str(tmp_path / "missing")], wh=64)
