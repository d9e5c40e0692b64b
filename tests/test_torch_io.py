"""The port's light-field I/O (lf/io.py) against the reference's
(`lfbm5d_tpu/lf/io.py`) on the CPU: files written by one package read back
by the other equal to the array, on the PIL/OpenCV path and the native one,
at 8 and 16 bits, grey and colour; the pattern and offsets; and the
metrics the CLI reports (`rmse`, `psnr_grid_device`) against the
reference's."""

import numpy as np
import pytest
import torch

from lfbm5d_tpu.lf import io as jio
from lfbm5d_tpu.lf import metrics as jmetrics
from lfbm5d_torch.lf import io as tio
from lfbm5d_torch.lf import metrics as tmetrics
from lfbm5d_torch.lf import synthetic_lf

torch.set_num_threads(2)

PAT = "SAI_%02d_%02d.png"
# the largest difference a round trip through a file of this depth can
# leave: half a step of 1 (8 bits) or 1/257 (16 bits), and the native
# writer's float32 arithmetic (the reference's tests/test_native_io.py
# bound, 0.51 steps)
TOL = {8: 0.51, 16: 0.51 / 257}


def _lf(channels, seed):
    return synthetic_lf(2, 3, 20, 24, channels=channels, seed=seed)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3])
def test_port_writes_reference_reads(tmp_path, depth, channels):
    lf = _lf(channels, depth + channels)
    tio.save_lf(lf, str(tmp_path), PAT, bit_depth=depth)
    back = jio.load_lf(str(tmp_path), PAT, 2, 3, use_native="never")
    assert back.shape == lf.shape
    assert np.abs(back - np.clip(lf, 0, 255)).max() <= TOL[depth]
    # and the port reads its own files to the same values
    own = tio.load_lf(str(tmp_path), PAT, 2, 3, use_native="never")
    np.testing.assert_array_equal(own, back)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3])
def test_reference_writes_port_reads(tmp_path, depth, channels):
    lf = _lf(channels, 10 + depth + channels)
    jio.save_lf(lf, str(tmp_path), PAT, bit_depth=depth)
    want = jio.load_lf(str(tmp_path), PAT, 2, 3, use_native="never")
    for mode in ("never", "auto"):
        got = tio.load_lf(str(tmp_path), PAT, 2, 3, use_native=mode)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want - np.clip(lf, 0, 255)).max() <= TOL[depth]


def test_quantised_tensor_round_trips_exactly(tmp_path):
    """fetch_rounded's values are fixed points of the writer: a tensor
    quantised on its device, written and read back, is unchanged, and the
    reference's fetch of the same values writes the same files."""
    lf = torch.as_tensor(_lf(3, 5) * 1.3 - 20.0)
    for depth in (8, 16):
        q = tio.fetch_rounded(lf, depth)
        tio.save_lf(q, str(tmp_path / f"p{depth}"), PAT, bit_depth=depth)
        back = tio.load_lf(str(tmp_path / f"p{depth}"), PAT, 2, 3)
        # 16 bits: v/257 in float32 on both sides, 1 ulp (1.5e-5) at 255
        np.testing.assert_allclose(back, q, rtol=0, atol=3e-5)
        jio.save_lf(q, str(tmp_path / f"j{depth}"), PAT, bit_depth=depth)
        np.testing.assert_array_equal(
            back, tio.load_lf(str(tmp_path / f"j{depth}"), PAT, 2, 3))


def test_pattern_offsets_and_tensor_input(tmp_path):
    """The printf pattern with index offsets (a central sub-grid of a larger
    stored grid) names the same files in both packages; a tensor LF is
    written as its values."""
    lf = _lf(3, 7)
    tio.save_lf(torch.as_tensor(lf), str(tmp_path), "v_%d_%d.png",
                s_offset=3, t_offset=1)
    assert tio._pattern_name("v_%d_%d.png", 3, 1) == "v_3_1.png"
    assert (tmp_path / "v_4_3.png").exists()
    got = tio.load_lf(str(tmp_path), "v_%d_%d.png", 2, 3, 3, 1)
    want = jio.load_lf(str(tmp_path), "v_%d_%d.png", 2, 3, 3, 1,
                       use_native="never")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        tio.load_lf(str(tmp_path), "v_%d_%d.png", 2, 3, use_native="never")
    with pytest.raises(ValueError):
        tio.load_lf(str(tmp_path), PAT, 2, 3, use_native="sometimes")


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    clean = rng.uniform(0, 255, (2, 3, 8, 9, 3))
    pred = clean + rng.normal(0, 9, clean.shape)
    pred[1, 2] = clean[1, 2]  # one SAI exact: inf dB
    assert tmetrics.rmse(torch.as_tensor(pred), clean) == pytest.approx(
        jmetrics.rmse(pred, clean), rel=1e-12)
    assert tmetrics.rmse(pred, clean) == pytest.approx(
        jmetrics.rmse(pred, clean), rel=1e-12)
    grid = tmetrics.psnr_grid_device(torch.as_tensor(pred), clean)
    want = jmetrics.psnr_grid_device(pred, clean)
    assert grid.shape == (2, 3) and np.isinf(grid[1, 2])
    np.testing.assert_allclose(grid, want, rtol=0, atol=1e-4)
    assert tmetrics.psnr(torch.as_tensor(pred), clean) == pytest.approx(
        jmetrics.psnr(np.clip(pred, 0, 255), clean), abs=1e-9)


def test_stage_timer_matches_reference(monkeypatch):
    """StageTimer sums repeated stages by name, as the reference's does;
    device_fence leaves host values (and tuples ending in one) alone."""
    from lfbm5d_tpu.utils.timing import StageTimer as JStageTimer
    from lfbm5d_torch.utils import timing

    clock = iter([0.0, 1.5, 2.0, 2.25, 3.0, 3.5])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    t = timing.StageTimer()
    for name in ("load", "denoise", "load"):
        with t.stage(name):
            pass
    assert dict(t.items()) == {"load": 2.0, "denoise": 0.25}
    assert t.seconds("denoise") == 0.25 and t.seconds("save") == 0.0
    assert set(dir(JStageTimer)) >= {"stage", "seconds", "items"}
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timing.device_fence((torch.zeros(2), [torch.zeros(1)]))
    timing.device_fence(np.zeros(2))
    assert synced == []
    timing.device_fence(torch.empty(2, device="meta"))
    assert synced == []
