"""The port's native PNG codec (lfbm5d_torch/native, built with g++ and
libpng under build/native/) against the PIL/OpenCV path and against the
reference's codec, as tests/test_native_io.py holds the reference's. Where
g++ or libpng is missing, the codec is unavailable and its tests skip."""

import numpy as np
import pytest
import torch

from lfbm5d_tpu.lf import io as jio
from lfbm5d_torch import native
from lfbm5d_torch.lf import synthetic_lf
from lfbm5d_torch.lf.io import load_lf, save_lf

torch.set_num_threads(2)

PAT = "SAI_%02d_%02d.png"


@pytest.fixture(scope="module", autouse=True)
def codec():
    if not native.available():
        pytest.skip(f"native io_accel not buildable here: "
                    f"{native.unavailable_reason()}")


@pytest.mark.parametrize("depth,channels", [(8, 3), (8, 1), (16, 1), (16, 3)])
def test_native_matches_fallback(tmp_path, depth, channels):
    lf = synthetic_lf(2, 3, 24, 28, channels=channels, seed=depth + channels)
    save_lf(lf, str(tmp_path), PAT, bit_depth=depth)
    a = load_lf(str(tmp_path), PAT, 2, 3, use_native="never")
    b = load_lf(str(tmp_path), PAT, 2, 3, use_native="always")
    assert b.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=3e-3)
    tol = 0.51 if depth == 8 else 0.01
    assert np.abs(b - lf).max() <= tol
    # the reference's PIL/OpenCV reader sees the same values
    c = jio.load_lf(str(tmp_path), PAT, 2, 3, use_native="never")
    np.testing.assert_allclose(c, b, atol=3e-3)


@pytest.mark.parametrize("depth", [8, 16])
def test_native_writer_rounds_half_up(tmp_path, depth):
    """The native writer rounds exact halves up (the io_png convention);
    PIL's fallback (np.round) sends them to even: they differ only there."""
    step = 1.0 if depth == 8 else 1.0 / 257
    vals = np.asarray([0.5, 1.5, 2.5, 254.5, 3.25, -4.0, 300.0]) * step
    lf = np.broadcast_to(vals, (1, 2, 3, 7)).reshape(1, 2, 3, 7, 1)
    save_lf(lf, str(tmp_path), PAT, bit_depth=depth)
    got = load_lf(str(tmp_path), PAT, 1, 2, use_native="always")[0, 0, 0, :, 0]
    scale = 1.0 if depth == 8 else 257.0
    want = np.clip(np.floor(vals * scale + 0.5), 0, 255 * scale) / scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_native_missing_file(tmp_path):
    lf = synthetic_lf(2, 2, 16, 16, channels=1, seed=0)
    save_lf(lf, str(tmp_path), PAT)
    (tmp_path / "SAI_01_01.png").unlink()
    with pytest.raises(IOError):
        load_lf(str(tmp_path), PAT, 2, 2, use_native="always")
    with pytest.raises(FileNotFoundError):
        load_lf(str(tmp_path), PAT, 2, 2, use_native="auto")


def test_native_save_roundtrip_and_reference_reader(tmp_path):
    """save -> load is exact up to quantisation at both depths, and the
    reference reads the port's native files to the same values."""
    lf = synthetic_lf(2, 2, 32, 40, channels=3, seed=4)
    for bd, tol in ((8, 0.51), (16, 0.51 / 257)):
        d = str(tmp_path / f"bd{bd}")
        save_lf(lf, d, "S_%02d_%02d.png", bit_depth=bd)
        back = load_lf(d, "S_%02d_%02d.png", 2, 2)
        assert np.abs(back - np.clip(lf, 0, 255)).max() <= tol
        ref = jio.load_lf(d, "S_%02d_%02d.png", 2, 2, use_native="never")
        np.testing.assert_allclose(ref, back, rtol=0, atol=1e-4)


def test_build_is_cached_under_build_dir():
    path = native.build()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert native.build() == path
    assert "lfbm5d_tpu" not in str(path)
