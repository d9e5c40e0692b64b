"""The port's two-step pipeline as a whole against the float64 NumPy oracle
and the JAX reference (CPU): engine 'torch' (dense plain step) and 'auto'
(the kernel step, whose kernels run their plain versions on the CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lfbm5d_tpu.config import DenoiseParams, StepParams, preset_denoise_params
from lfbm5d_tpu.lf import psnr as np_psnr
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.oracle import oracle_denoise
from lfbm5d_tpu.pipeline import ht_step as j_ht_step
from lfbm5d_tpu.pipeline import run_bm5d as j_run_bm5d
from lfbm5d_torch import LFDenoiser, LFSuperResolver, psnr_device
from lfbm5d_torch import run_bm5d as _run_bm5d
from lfbm5d_torch.config import SRParams, from_reference
from lfbm5d_torch.pipeline import (
    build_denoise_fn,
    ht_step,
    run_sr,
    wiener_step,
)
from lfbm5d_torch.pipeline.engine import build_kernel_step
from lfbm5d_torch.pipeline.streaming import denoise_batch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)
ENGINES = ["torch", "auto"]


def run_bm5d(noisy, params, **kw):
    """The port's run_bm5d on the port's copy of the reference params, on
    the CPU."""
    return _run_bm5d(noisy, from_reference(params), device="cpu", **kw)


def tiny_params(sigma=20.0):
    return DenoiseParams(
        sigma=sigma,
        ht=StepParams(tau_match=2500.0, **TINY),
        wiener=StepParams(tau_match=400.0, **TINY),
        chunk=32,
    )


@pytest.fixture(scope="module")
def tiny_case():
    """The reference's tests/test_pipeline.py parity case."""
    clean = synthetic_lf(2, 2, 20, 24, channels=1, seed=0)
    noisy = add_noise_np(clean, 20.0, seed=1)
    params = tiny_params()
    return clean, noisy, params, oracle_denoise(noisy, params)


@pytest.mark.parametrize("engine", ENGINES)
def test_f64_matches_oracle(tiny_case, engine):
    _, noisy, params, (ob, of) = tiny_case
    tb, tf = run_bm5d(noisy, params, dtype="float64", engine=engine)
    assert tb.dtype == torch.float64 and tf.shape == noisy.shape
    assert np.abs(tb.numpy() - ob).max() < 1e-9
    assert np.abs(tf.numpy() - of).max() < 1e-9


def test_f64_matches_jax_pallas_interpret(tiny_case):
    """The reference's kernel engine (Pallas, interpret mode on the CPU)."""
    _, noisy, params, _ = tiny_case
    jb, jf = j_run_bm5d(noisy, params, dtype="float64", engine="pallas")
    for engine in ENGINES:
        tb, tf = run_bm5d(noisy, params, dtype="float64", engine=engine)
        assert np.abs(tb.numpy() - np.asarray(jb)).max() < 1e-9
        assert np.abs(tf.numpy() - np.asarray(jf)).max() < 1e-9


@pytest.mark.parametrize("engine", ENGINES)
def test_matched_preset_9x9_rgb_matches_jax_xla(engine):
    """p_ang reference subsampling, flat_tau and OPP at the flagship's
    angular grid and preset."""
    params = preset_denoise_params("matched", 25.0)
    clean = synthetic_lf(9, 9, 24, 32, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(clean, 25.0, seed=1)
    jb, jf = j_run_bm5d(noisy, params, dtype="float64", engine="xla")
    tb, tf = run_bm5d(noisy, params, dtype="float64", engine=engine)
    assert np.abs(tb.numpy() - np.asarray(jb)).max() < 1e-9
    assert np.abs(tf.numpy() - np.asarray(jf)).max() < 1e-9
    assert psnr_device(tf, clean) > psnr_device(torch.as_tensor(noisy),
                                                clean) + 3.0


@pytest.mark.parametrize("engine", ENGINES)
def test_f32_psnr_band_and_jax_xla(tiny_case, engine):
    clean, noisy, params, (_, of) = tiny_case
    tb, tf = run_bm5d(noisy, params, dtype="float32", engine=engine)
    assert tf.dtype == torch.float32
    p_o = np_psnr(np.clip(of, 0, 255), clean)
    p_t = psnr_device(tf, clean)
    assert abs(p_o - p_t) < 0.05, (p_o, p_t)
    assert p_t > np_psnr(np.clip(noisy, 0, 255), clean) + 3.0
    _, jf = j_run_bm5d(noisy, params, dtype="float32", engine="xla")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-3)


VARIANTS = {
    "yuv": dict(color_space="yuv"),
    "bm-source-noisy": dict(
        wiener=StepParams(tau_match=2500.0, bm_source="noisy", **TINY)),
    "dct-stack-16": dict(
        ht=StepParams(tau_match=2500.0, tau_5d="dct",
                      **dict(TINY, n_sim=16)),
        wiener=StepParams(tau_match=400.0, tau_5d="dct",
                          **dict(TINY, n_sim=16))),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_match_jax_xla(variant):
    """Options off the matched path, through the dense plain step."""
    clean = synthetic_lf(2, 2, 18, 20, channels=3, seed=4)
    noisy = add_noise_np(clean, 25.0, seed=5)
    params = tiny_params(25.0).replace(**VARIANTS[variant])
    jb, jf = j_run_bm5d(noisy, params, dtype="float64", engine="xla")
    tb, tf = run_bm5d(noisy, params, dtype="float64", engine="torch")
    assert np.abs(tb.numpy() - np.asarray(jb)).max() < 1e-9
    assert np.abs(tf.numpy() - np.asarray(jf)).max() < 1e-9


def test_ht_step_and_sigma_override(tiny_case):
    _, noisy, params, _ = tiny_case
    got = ht_step(noisy, 20.0, from_reference(params.ht), 2.7, "rgb", 32,
                  dtype="float64", device="cpu")
    want = np.asarray(j_ht_step(noisy, 20.0, params.ht, 2.7, "rgb", 32,
                                dtype="float64"))
    assert np.abs(got.numpy() - want).max() < 1e-9
    # a sigma_c override replaces params.sigma
    b1, f1 = run_bm5d(noisy, params.replace(sigma=5.0), dtype="float64",
                      engine="torch", sigma_c=torch.tensor([20.0]))
    b2, f2 = run_bm5d(noisy, params, dtype="float64", engine="torch")
    assert torch.equal(f1, f2) and torch.equal(b1, b2)


def test_unknown_engine_raises(tiny_case):
    _, noisy, params, _ = tiny_case
    with pytest.raises(ValueError, match="engine"):
        run_bm5d(noisy, params, engine="pallas")


def test_run_bm5d_raises_without_cuda(tiny_case, monkeypatch):
    """An array input runs on the CUDA card unless device='cpu' is asked
    for: without a card the call raises instead of running on the host."""
    _, noisy, params, _ = tiny_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_bm5d(noisy, from_reference(params))


ENTRY_POINTS = {
    "ht_step": lambda x, p: ht_step(x, 20.0, p.ht),
    "wiener_step": lambda x, p: wiener_step(x, x, 20.0, p.wiener),
    "build_denoise_fn": lambda x, p: build_denoise_fn(p, 2, 2, 20, 24, 1),
    "build_kernel_step": lambda x, p: build_kernel_step(
        p.ht, 2.7, 2, 2, 20, 24, 1, False),
    "run_sr": lambda x, p: run_sr(x, SRParams(ht=p.ht, wiener=p.wiener)),
    "LFDenoiser": lambda x, p: LFDenoiser(p)(x),
    "LFDenoiser.batch": lambda x, p: LFDenoiser(p).batch(x[None]),
    "denoise_batch": lambda x, p: denoise_batch(x[None], p),
    "LFSuperResolver": lambda x, p: LFSuperResolver(
        SRParams(ht=p.ht, wiener=p.wiener))(x),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(tiny_case, monkeypatch, entry):
    """Every entry point resolves device=None to the card for an array
    (or for no input at all) and raises without one."""
    _, noisy, params, _ = tiny_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](noisy, from_reference(params))


def test_tensor_input_keeps_its_device(tiny_case):
    """device=None takes a tensor's own device (here the CPU)."""
    _, noisy, params, _ = tiny_case
    x = torch.as_tensor(noisy)
    b, f = _run_bm5d(x, from_reference(params), dtype="float64")
    want = run_bm5d(noisy, params, dtype="float64")
    assert f.device.type == "cpu" and torch.equal(f, want[1])
    assert torch.equal(b, want[0])


def test_import_and_run_without_jax():
    """In a fresh process (this one imported jax via conftest), the port,
    its CLI, bench, streaming and native codec modules among them, imports
    and denoises on the CPU with neither jax nor the JAX package
    (`lfbm5d_tpu`) ever loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import lfbm5d_torch\n"
        "import lfbm5d_torch.cli, lfbm5d_torch.native, lfbm5d_torch.utils\n"
        "import lfbm5d_torch.bench\n"
        "import lfbm5d_torch.pipeline.stream_io\n"
        "import lfbm5d_torch.pipeline.driver, lfbm5d_torch.parallel\n"
        "from lfbm5d_torch.lf import add_noise_np, synthetic_lf\n"
        "from lfbm5d_torch import StepParams, DenoiseParams\n"
        "sp = dict(n_sim=4, n_search=2, n_disp=1, k=8, p=4)\n"
        "p = DenoiseParams(sigma=20.0, ht=StepParams(**sp),\n"
        "                  wiener=StepParams(tau_match=400.0, **sp))\n"
        "x = add_noise_np(synthetic_lf(2, 2, 16, 16, channels=3, seed=0),\n"
        "                 20.0, seed=1)\n"
        "b, f = lfbm5d_torch.run_bm5d(x, p, device='cpu')\n"
        "assert f.shape == x.shape and bool(torch.isfinite(f).all())\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('jax') or m.startswith('lfbm5d_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
