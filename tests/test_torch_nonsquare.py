"""Non-square angular grids (aH != aW) on the CPU. With the same angular
transform on both axes, kron(F, F) commutes with swapping s and t, so a
swapped angular axis passes every check at a square grid: here the group
kernels' plain versions (the kernel step), the whole pipeline on every
engine and the bf16 chain's plain step are held against the JAX reference
and the float64 oracle at 3x5, 5x3 and 2x4."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.synth import synthetic_lf_multi
from lfbm5d_tpu.oracle import oracle_denoise
from lfbm5d_tpu.pipeline import denoise as jden
from lfbm5d_tpu.pipeline import run_bm5d as j_run_bm5d
from lfbm5d_tpu.pipeline.engine import build_kernel_step as j_kernel_step
from lfbm5d_torch import run_bm5d
from lfbm5d_torch.config import from_reference
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import build_kernel_step

torch.set_num_threads(2)

GRIDS = [(3, 5), (5, 3)]
H, W, C = 20, 24, 2
SIGMA = 25.0
TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)
STEP_CASES = {
    "ht": (StepParams(tau_match=2500.0, **TINY), False),
    "wiener": (StepParams(tau_match=400.0, **TINY), True),
    "ht-flat-pang": (StepParams(tau_match=2500.0, n_sim=8, n_search=4,
                                n_disp=1, k=8, p=4, p_ang=2, flat_tau=1.3),
                     False),
}
# run_bm5d engines: (engine, fused)
ENGINES = {"torch": ("torch", None), "auto": ("auto", None),
           "auto-two-kernel": ("auto", False)}
# the bf16 chain: bound on the relative L2 of num and den against the
# reference's bf16 step, and how much farther the f32 step must sit (both
# tests/test_torch_bf16.py's; measured on the CPU at 3x5: ht 1.1e-3 /
# 7.0e-4, wiener 6.2e-4 / 1.5e-4, the f32 step 7.2-21x farther)
BF16_REL_MAX = 3e-3
CHAIN_SEPARATION = 4.0


def _lf_pair(a_h, a_w, c=C):
    """Half-flat content, as tests/test_torch_group.py's: (noisy, a basic
    estimate)."""
    clean = synthetic_lf_multi(a_h, a_w, H, W, c, disps=(0.0, 2.0), seed=0,
                               blob_frac=0.25, flat_frac=0.4)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    return noisy, clean + add_noise_np(np.zeros_like(clean), 3.0, seed=2)


def _inputs(sp, noisy, basic, wiener, dtype, c=C):
    t = getattr(torch, dtype)
    xp = tden._flat_pad(torch.as_tensor(noisy, dtype=t), sp.pad)
    bp = (tden._flat_pad(torch.as_tensor(basic, dtype=t), sp.pad)
          if wiener else None)
    mp = bp if wiener else xp
    return xp, mp, tden._sigma_channels(SIGMA, "rgb", c, dtype), bp


def _jax(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_kernel_step_num_den_match_reference(grid, case):
    """num/den of the port's kernel step (the group kernels' plain
    versions) against the reference's dense `_build_step`, float64."""
    a_h, a_w = grid
    sp, wiener = STEP_CASES[case]
    lam = 0.0 if wiener else 2.7
    noisy, basic = _lf_pair(a_h, a_w)
    xp, mp, sig, bp = _inputs(sp, noisy, basic, wiener, "float64")
    step = build_kernel_step(from_reference(sp), lam, a_h, a_w, H, W, C,
                             wiener, "float64", "cpu")
    assert step.route == "fused"
    num, den = step(xp, mp, sig, bp)
    jstep = jden._build_step(sp, lam, a_h, a_w, H, W, C, 64, wiener,
                             "float64")
    jnum, jden_ = jstep(_jax(xp), _jax(mp), _jax(sig), _jax(bp))
    assert num.shape == (a_h * a_w, H + 2 * sp.pad, W + 2 * sp.pad, C)
    np.testing.assert_allclose(num.numpy(), np.asarray(jnum), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden_), rtol=0,
                               atol=1e-9)
    assert (den.numpy() > 0).any()


def _params():
    return DenoiseParams(sigma=SIGMA,
                         ht=StepParams(tau_match=2500.0, **TINY),
                         wiener=StepParams(tau_match=400.0, **TINY),
                         chunk=32)


@pytest.fixture(scope="module")
def oracle_2x4():
    clean = synthetic_lf(2, 4, H, W, channels=1, seed=0)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    return noisy, oracle_denoise(noisy, _params())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_run_bm5d_2x4_matches_oracle(oracle_2x4, engine):
    noisy, (ob, of) = oracle_2x4
    eng, fused = ENGINES[engine]
    tb, tf = run_bm5d(noisy, from_reference(_params()), dtype="float64",
                      engine=eng, fused=fused, device="cpu")
    assert np.abs(tb.numpy() - ob).max() < 1e-9
    assert np.abs(tf.numpy() - of).max() < 1e-9


@pytest.fixture(scope="module")
def jax_xla_runs():
    """{grid: (noisy RGB LF, the reference's XLA engine (basic, final))},
    float64."""
    out = {}
    for a_h, a_w in GRIDS:
        clean = synthetic_lf(a_h, a_w, H, W, channels=3, disp_bg=1,
                             disp_fg=2, seed=0)
        noisy = add_noise_np(clean, SIGMA, seed=1)
        jb, jf = j_run_bm5d(noisy, _params(), dtype="float64", engine="xla")
        out[(a_h, a_w)] = noisy, (np.asarray(jb), np.asarray(jf))
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_run_bm5d_matches_jax_xla(jax_xla_runs, grid, engine):
    noisy, (jb, jf) = jax_xla_runs[grid]
    eng, fused = ENGINES[engine]
    tb, tf = run_bm5d(noisy, from_reference(_params()), dtype="float64",
                      engine=eng, fused=fused, device="cpu")
    assert tf.shape == noisy.shape
    assert np.abs(tb.numpy() - jb).max() < 1e-9
    assert np.abs(tf.numpy() - jf).max() < 1e-9


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", ["ht", "wiener"])
def test_plain_bf16_step_3x5_matches_reference_bf16(case):
    """The port's plain bf16 step against the reference's build_kernel_step
    (group_dtype='bfloat16', Pallas in interpret mode), f32, by relative L2
    of num and den, as tests/test_torch_bf16.py holds it at 3x3."""
    a_h, a_w = GRIDS[0]
    sp, wiener = STEP_CASES[case]
    lam = 0.0 if wiener else 2.7
    noisy, basic = _lf_pair(a_h, a_w, 3)
    xp, mp, sig, bp = _inputs(sp, noisy, basic, wiener, "float32", 3)
    got = {}
    for chain in (torch.bfloat16, None):
        step = build_kernel_step(from_reference(sp), lam, a_h, a_w, H, W, 3,
                                 wiener, "float32", "cpu", chain_dtype=chain)
        assert step.chain == chain
        got[chain] = [x.numpy() for x in step(xp, mp, sig, bp)]
    jstep = j_kernel_step(sp, lam, a_h, a_w, H, W, 3, wiener, "float32",
                          interpret=True, group_dtype="bfloat16")
    want = [np.asarray(x) for x in jstep(_jax(xp), _jax(mp), _jax(sig),
                                         _jax(bp))]
    for i, name in enumerate(("num", "den")):
        rel = _rel(got[torch.bfloat16][i], want[i])
        assert rel <= BF16_REL_MAX, (name, rel)
        assert _rel(got[None][i], want[i]) >= CHAIN_SEPARATION * rel, name
