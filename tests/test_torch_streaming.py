"""The port's batch path (pipeline/streaming.py, parallel/devices.py) and
disk-to-disk streaming (pipeline/stream_io.py), case for case beside the
reference's tests/test_streaming.py, on the CPU.

The reference's mesh becomes a list of devices that the LFs go round;
torch has no virtual CUDA devices, so the round-robin runs over
["cpu", "cpu"] (and over a meta device where a test must tell the devices
apart), and faults are injected by monkeypatching the per-LF call."""

import os

import numpy as np
import pytest
import torch

from lfbm5d_tpu.config import DenoiseParams as JDenoiseParams
from lfbm5d_tpu.config import StepParams as JStepParams
from lfbm5d_tpu.parallel import denoise_batch as j_denoise_batch
from lfbm5d_tpu.parallel import make_mesh
from lfbm5d_torch.config import DenoiseParams, StepParams, from_reference
from lfbm5d_torch.lf import add_noise_np, synthetic_lf
from lfbm5d_torch.lf.io import load_lf, save_lf
from lfbm5d_torch.parallel import make_devices
from lfbm5d_torch.pipeline import run_bm5d
from lfbm5d_torch.pipeline import streaming as S
from lfbm5d_torch.pipeline.stream_io import _default_run, stream_denoise_dirs

torch.set_num_threads(2)

TINY = dict(n_sim=4, n_search=3, n_disp=1, k=8, p=4)
CPU2 = ["cpu", "cpu"]
PAT = "SAI_%02d_%02d.png"


def j_params():
    return JDenoiseParams(
        sigma=20.0, ht=JStepParams(tau_match=2500.0, **TINY),
        wiener=JStepParams(tau_match=400.0, **TINY), chunk=32)


def params():
    return from_reference(j_params())


@pytest.fixture(scope="module")
def batch():
    lfs = []
    for s in range(4):
        clean = synthetic_lf(2, 2, 16, 16, channels=1, seed=s)
        lfs.append(add_noise_np(clean, 20.0, seed=100 + s))
    return np.stack(lfs)


@pytest.fixture(scope="module")
def batch_ref(batch):
    """The port's batch on one CPU device, float32 and float64."""
    return {dt: S.denoise_batch(batch, params(), devices=["cpu"], dtype=dt)
            for dt in ("float32", "float64")}


def test_make_devices(monkeypatch):
    devs = make_devices(4, "cpu")
    assert devs == [torch.device("cpu")] * 4
    assert make_devices(device_type="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_devices(2, "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_devices()  # never the host unless asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_devices() == [torch.device("cuda", 0),
                              torch.device("cuda", 1)]
    with pytest.raises(ValueError):
        make_devices(99)


def test_batch_matches_single(batch, batch_ref):
    """Each LF of the batch is run_bm5d on that LF, and agrees with the
    reference's batch (XLA engine) in float64."""
    b, f = batch_ref["float64"]
    assert f.shape == batch.shape and f.dtype == torch.float64
    bs, fs = run_bm5d(batch[1], params(), dtype="float64", device="cpu")
    assert torch.equal(f[1], fs) and torch.equal(b[1], bs)
    jb, jf = j_denoise_batch(batch, j_params(), dtype="float64")
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-9)


def test_round_robin_matches_one_device(batch, batch_ref):
    """The reference's sharded-vs-unsharded case: LFs over two devices give
    the one-device batch exactly, on devices[0]."""
    b_u, f_u = batch_ref["float32"]
    b_s, f_s = S.denoise_batch(batch, params(), devices=CPU2)
    assert torch.equal(f_s, f_u) and torch.equal(b_s, b_u)
    assert f_s.device == torch.device("cpu")


def test_round_robin_any_batch_size(batch, monkeypatch):
    """The reference's mesh needs B divisible by its size; the port's
    devices take LF i on devices[i % len(devices)] for any B."""
    seen = []

    def record(x, p, dtype, engine):
        seen.append(x.device.type)
        z = torch.zeros(x.shape, dtype=x.dtype)
        return z, z

    monkeypatch.setattr(S, "run_bm5d", record)
    b, f = S.denoise_batch(batch[:3], params(), devices=["cpu", "meta"])
    assert seen == ["cpu", "meta", "cpu"] and f.shape == batch[:3].shape
    with pytest.raises(ValueError):
        S.denoise_batch(batch[:3], params(), devices=[])
    with pytest.raises(ValueError):
        S.denoise_batch(batch[:3], params(), devices=CPU2, on_fail="skip")


def test_kernel_engine_matches_torch_engine(batch, batch_ref):
    """The reference's kernel-engine-over-a-mesh case: engine 'auto' (the
    kernel step's plain versions on the CPU) over two devices equals the
    dense engine's batch in float64, and the reference's sharded XLA batch
    in float32 within docs/PARITY.md's 2e-3."""
    _, f_auto = S.denoise_batch(batch, params(), devices=CPU2,
                                dtype="float64", engine="auto")
    _, f_torch = S.denoise_batch(batch, params(), devices=CPU2,
                                 dtype="float64", engine="torch")
    assert torch.equal(f_auto, batch_ref["float64"][1])
    np.testing.assert_allclose(f_auto.numpy(), f_torch.numpy(), rtol=0,
                               atol=1e-9)
    _, jf = j_denoise_batch(batch, j_params(), mesh=make_mesh(2))
    np.testing.assert_allclose(batch_ref["float32"][1].numpy(),
                               np.asarray(jf), rtol=0, atol=2e-3)


def _flaky(faults, counter):
    real = S.run_bm5d

    def call(x, p, dtype, engine):
        counter["n"] += 1
        if counter["n"] in faults:
            raise RuntimeError("injected device fault")
        return real(x, p, dtype=dtype, engine=engine)

    return call


def test_retry_per_lf_isolates_fault(batch, batch_ref, monkeypatch):
    """One faulted LF does not poison the batch: its call is retried, then
    degraded to the identity estimate, and the report names it."""
    f_ref = batch_ref["float32"][1]
    calls = {"n": 0}
    # LF 2's first two attempts fault (calls 3 and 4 are both LF 2's)
    monkeypatch.setattr(S, "run_bm5d", _flaky((3, 4), calls))
    (b_out, f_out), report = S.denoise_batch(
        batch, params(), devices=CPU2, retries=1, on_fail="identity",
        return_report=True)
    assert [r["index"] for r in report] == [2]
    assert report[0]["attempts"] == 2 and "injected" in report[0]["error"]
    np.testing.assert_allclose(f_out[2].numpy(), batch[2], atol=1e-5)
    np.testing.assert_allclose(b_out[2].numpy(), batch[2], atol=1e-5)
    for i in (0, 1, 3):
        assert torch.equal(f_out[i], f_ref[i])
    # a single fault recovers exactly through the retry
    calls["n"] = 0
    monkeypatch.setattr(S, "run_bm5d", _flaky((3,), calls))
    (_, f2), report2 = S.denoise_batch(
        batch, params(), devices=CPU2, retries=1, on_fail="identity",
        return_report=True)
    assert report2 == [] and torch.equal(f2, f_ref)


def test_default_behavior_still_raises(batch, monkeypatch):
    def always_fail(x, p, dtype, engine):
        raise RuntimeError("hard fault")

    monkeypatch.setattr(S, "run_bm5d", always_fail)
    with pytest.raises(RuntimeError, match="hard fault"):
        S.denoise_batch(batch, params(), devices=["cpu"])


def _jobs(batch, tmp_path, tag, n=3):
    jobs = []
    for i in range(n):
        d_in = tmp_path / f"{tag}in_{i}"
        save_lf(np.clip(batch[i], 0, 255), str(d_in), PAT)
        jobs.append((str(d_in), str(tmp_path / f"{tag}out_{i}")))
    return jobs


def test_stream_denoise_dirs_roundtrip(batch, tmp_path):
    """Disk->disk streaming: decode -> denoise -> encode with decode-ahead;
    outputs match the in-memory batch on the saved (quantised) inputs."""
    jobs = _jobs(batch, tmp_path, "")
    report = stream_denoise_dirs(jobs, params(), 2, 2, device="cpu")
    assert report.n_done == 3 and report.n_failed == 0
    assert report.seconds_total > 0 and len(report.lf_seconds) == 3
    assert 0 < report.seconds_device <= report.seconds_total
    quant = np.stack([load_lf(j[0], PAT, 2, 2) for j in jobs])
    _, f_ref = S.denoise_batch(quant, params(), devices=["cpu"])
    for i, j in enumerate(jobs):
        got = load_lf(j[1], PAT, 2, 2)
        want = np.floor(np.clip(f_ref[i].numpy(), 0, 255) + 0.5)
        np.testing.assert_array_equal(got, want)


def test_stream_denoise_dirs_fault_isolation(batch, tmp_path):
    jobs = _jobs(batch, tmp_path, "f")
    calls = {"n": 0}

    def flaky(fn, lf_dev, sigma_c):
        calls["n"] += 1
        # job 1 faults on both attempts (calls 2 and 3 with retries=1)
        if calls["n"] in (2, 3):
            raise RuntimeError("injected stream fault")
        return _default_run(fn, lf_dev, sigma_c)

    report = stream_denoise_dirs(jobs, params(), 2, 2, retries=1,
                                 on_fail="skip", device="cpu", _run=flaky)
    assert report.n_done == 2 and report.n_failed == 1
    assert report.failures[0]["job"] == jobs[1]
    assert report.failures[0]["attempts"] == 2
    assert not os.path.exists(jobs[1][1])  # skip: no output for the bad LF
    assert os.path.exists(jobs[0][1]) and os.path.exists(jobs[2][1])


def test_round_robin_large_grid_matches_dense_engine():
    """The reference's >128-SAI tier case: 12x12 grids (144 SAIs, the
    `banked` route of the kernel step) over two devices, each LF equal to
    the dense engine in float64."""
    tiny = dict(n_sim=4, n_search=2, n_disp=1, k=4, p=3)
    p = DenoiseParams(sigma=20.0, ht=StepParams(tau_match=2500.0, **tiny),
                      wiener=StepParams(tau_match=400.0, **tiny), chunk=32)
    big = np.stack([add_noise_np(synthetic_lf(12, 12, 8, 8, channels=1,
                                              seed=s), 20.0, seed=50 + s)
                    for s in range(2)])
    b_s, f_s = S.denoise_batch(big, p, devices=CPU2, dtype="float64")
    for i in range(2):
        b_x, f_x = run_bm5d(big[i], p, dtype="float64", engine="torch",
                            device="cpu")
        assert float((f_s[i] - f_x).abs().max()) < 1e-9
        assert float((b_s[i] - b_x).abs().max()) < 1e-9


def test_round_robin_float64_matches_reference(batch):
    """The reference's launched-tier case, whose point is exactness over
    the mesh: the port's float64 batch over two devices, a sequence of LF
    tensors as input, equals the reference's single-program float64 batch
    (XLA engine) to 1e-9."""
    lfs = [torch.as_tensor(x) for x in batch[:2]]
    b_s, f_s = S.denoise_batch(lfs, params(), devices=CPU2, dtype="float64")
    jb, jf = j_denoise_batch(batch[:2], j_params(), dtype="float64")
    assert float(np.abs(f_s.numpy() - np.asarray(jf)).max()) < 1e-9
    assert float(np.abs(b_s.numpy() - np.asarray(jb)).max()) < 1e-9


def test_stream_denoise_dirs_torch_engine(batch, tmp_path):
    """The reference's heavy-tier streaming case, whose point is that the
    stream runs the engine it is given: engine='torch' (the dense plain
    step) writes the in-memory batch's outputs on the saved inputs."""
    jobs = _jobs(batch, tmp_path, "t", n=2)
    report = stream_denoise_dirs(jobs, params(), 2, 2, engine="torch",
                                 device="cpu")
    assert report.n_done == 2 and report.n_failed == 0
    quant = np.stack([load_lf(j[0], PAT, 2, 2) for j in jobs])
    _, f_ref = S.denoise_batch(quant, params(), devices=["cpu"],
                               engine="torch")
    for i, j in enumerate(jobs):
        got = load_lf(j[1], PAT, 2, 2)
        want = np.floor(np.clip(f_ref[i].numpy(), 0, 255) + 0.5)
        np.testing.assert_array_equal(got, want)


def test_lfdenoiser_batch(batch, batch_ref):
    """LFDenoiser.batch runs denoise_batch on its device, or on the devices
    it is given."""
    from lfbm5d_torch.models import LFDenoiser

    b, f = LFDenoiser(params(), device="cpu").batch(batch)
    assert torch.equal(f, batch_ref["float32"][1])
    assert torch.equal(b, batch_ref["float32"][0])
    _, f2 = LFDenoiser(params(), dtype="float64").batch(
        torch.as_tensor(batch[:2]), devices=CPU2)
    assert torch.equal(f2, batch_ref["float64"][1][:2])
