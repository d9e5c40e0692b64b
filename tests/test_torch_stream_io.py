"""Disk-to-disk streaming of the port (pipeline/stream_io.py,
pipeline/driver.py) on the CPU: the reference's tests/test_driver.py case,
a stream that mixes channel counts (each shape keeps its own per-channel
sigmas), the identity and raise fallbacks, and agreement with the
reference's stream_directories on the same directories."""

import numpy as np
import pytest
import torch

from lfbm5d_tpu.config import DenoiseParams as JDenoiseParams
from lfbm5d_tpu.config import StepParams as JStepParams
from lfbm5d_tpu.pipeline.driver import stream_directories as j_stream_dirs
from lfbm5d_torch.config import from_reference
from lfbm5d_torch.lf import add_noise_np, synthetic_lf
from lfbm5d_torch.lf.io import load_lf, save_lf
from lfbm5d_torch.pipeline import run_bm5d
from lfbm5d_torch.pipeline.driver import stream_directories
from lfbm5d_torch.pipeline.stream_io import stream_denoise_dirs

torch.set_num_threads(2)

TINY = dict(n_sim=4, n_search=3, n_disp=1, k=8, p=4)
PAT = "SAI_%02d_%02d.png"


def j_params():
    return JDenoiseParams(
        sigma=20.0, ht=JStepParams(**TINY),
        wiener=JStepParams(tau_match=400.0, **TINY), chunk=32)


def params():
    return from_reference(j_params())


def _write(tmp_path, name, seed, channels=1):
    d = tmp_path / name
    clean = synthetic_lf(2, 2, 16, 16, channels=channels, seed=seed)
    save_lf(add_noise_np(clean, 20.0, seed=seed), str(d), PAT)
    return str(d)


def _expected(d_in, p, bit_depth=8):
    """The saved input denoised in memory, rounded as the writer rounds."""
    _, f = run_bm5d(load_lf(d_in, PAT, 2, 2), p, device="cpu")
    if bit_depth == 16:
        return np.floor(np.clip(f.numpy(), 0, 255) * 257.0 + 0.5) / 257.0
    return np.floor(np.clip(f.numpy(), 0, 255) + 0.5)


def test_stream_ok_and_fault_isolation(tmp_path):
    """The reference's driver case: a corrupt LF (one SAI missing) fails
    alone; the others are written, over two devices."""
    ins = [_write(tmp_path, f"in{i}", i) for i in range(4)]
    outs = [str(tmp_path / f"out{i}") for i in range(4)]
    (tmp_path / "in2" / "SAI_01_00.png").unlink()
    status = stream_directories(ins, outs, PAT, 2, 2, params(),
                                devices=["cpu", "cpu"])
    assert [s["ok"] for s in status] == [True, True, False, True]
    assert "error" in status[2] and "error" not in status[0]
    for i in (0, 1, 3):
        got = load_lf(outs[i], PAT, 2, 2)
        assert got.shape == (2, 2, 16, 16, 1)
        np.testing.assert_array_equal(got, _expected(ins[i], params()))
    with pytest.raises(ValueError):
        stream_directories(ins, outs[:2], PAT, 2, 2, params())


def test_stream_directories_matches_reference(tmp_path):
    """Port and reference, the same directories in, SAIs within 1 LSB of
    each other out (float32 on both sides)."""
    ins = [_write(tmp_path, f"r{i}", 10 + i) for i in range(2)]
    outs = [str(tmp_path / f"ro{i}") for i in range(2)]
    j_outs = [str(tmp_path / f"jo{i}") for i in range(2)]
    assert all(s["ok"] for s in stream_directories(
        ins, outs, PAT, 2, 2, params(), devices=["cpu"]))
    assert all(s["ok"] for s in j_stream_dirs(ins, j_outs, PAT, 2, 2,
                                              j_params()))
    for o, jo in zip(outs, j_outs):
        d = load_lf(o, PAT, 2, 2) - load_lf(jo, PAT, 2, 2)
        assert np.abs(d).max() <= 1.0


def test_mixed_channel_stream_keeps_sigmas_per_shape(tmp_path):
    """RGB, grey, RGB: the third LF reuses the first one's pipeline and its
    three per-channel sigmas, not the grey LF's single one, so every output
    equals its LF denoised alone."""
    p = params().replace(color_space="opp")
    ins = [_write(tmp_path, "c0", 0, 3), _write(tmp_path, "c1", 1, 1),
           _write(tmp_path, "c2", 2, 3)]
    jobs = [(d, d + "_out") for d in ins]
    report = stream_denoise_dirs(jobs, p, 2, 2, device="cpu", lookahead=1)
    assert report.n_done == 3 and report.n_failed == 0
    for d_in, d_out in jobs:
        np.testing.assert_array_equal(load_lf(d_out, PAT, 2, 2),
                                      _expected(d_in, p))


def test_identity_and_raise_fallbacks(tmp_path):
    ins = [_write(tmp_path, f"x{i}", 20 + i) for i in range(2)]
    jobs = [(d, d + "_out") for d in ins]

    calls = {"n": 0}

    def fail_second(fn, lf_dev, sigma_c):
        calls["n"] += 1
        if calls["n"] > 1:  # every attempt after the first LF's faults
            raise RuntimeError("injected stream fault")
        return fn(lf_dev, sigma_c)[1]

    report = stream_denoise_dirs(jobs, params(), 2, 2, retries=2,
                                 on_fail="identity", device="cpu",
                                 bit_depth=16, out_pattern="O_%d_%d.png",
                                 _run=fail_second)
    assert report.n_done == 2 and report.n_failed == 1
    assert report.failures[0]["attempts"] == 3
    # identity: the noisy input itself, written at 16 bits
    np.testing.assert_allclose(load_lf(jobs[1][1], "O_%d_%d.png", 2, 2),
                               load_lf(ins[1], PAT, 2, 2), atol=1e-4)
    np.testing.assert_allclose(load_lf(jobs[0][1], "O_%d_%d.png", 2, 2),
                               _expected(ins[0], params(), 16), atol=1e-5)

    def always(fn, lf_dev, sigma_c):
        raise RuntimeError("hard stream fault")

    with pytest.raises(RuntimeError, match="hard stream fault"):
        stream_denoise_dirs(jobs, params(), 2, 2, on_fail="raise",
                            device="cpu", _run=always)
    with pytest.raises(ValueError):
        stream_denoise_dirs(jobs, params(), 2, 2, on_fail="drop",
                            device="cpu")
    assert stream_denoise_dirs([], params(), 2, 2, device="cpu").n_done == 0


def test_stream_raises_without_cuda(tmp_path, monkeypatch):
    """Without a device the streams run on the card: where there is none,
    stream_denoise_dirs raises and stream_directories reports the LF as
    failed."""
    jobs = [(_write(tmp_path, "n0", 0), str(tmp_path / "n0_out"))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_denoise_dirs(jobs, params(), 2, 2)
    status = stream_directories([jobs[0][0]], [jobs[0][1]], PAT, 2, 2,
                                params())
    assert not status[0]["ok"] and "no CUDA device" in status[0]["error"]
