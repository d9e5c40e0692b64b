"""The group stage: the port's kernel step on the CPU (the group kernel's
plain version, deferred den + Kaiser convolution) and its dense step against
the JAX reference's `_build_step` num/den, float64, 3x3 grids (the angular
DCT is not symmetric there)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import StepParams
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.synth import synthetic_lf_multi
from lfbm5d_tpu.pipeline import denoise as jden
from lfbm5d_torch.config import from_reference
from lfbm5d_torch.kernels.fused import GroupTables, fused_group_step
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import build_kernel_step, kaiser_conv

torch.set_num_threads(2)

AH, AW, H, W, C = 3, 3, 24, 32, 2
SIGMA = 25.0
CASES = {
    "ht": (StepParams(tau_match=2500.0, n_sim=8, n_search=4, n_disp=1, k=8,
                      p=3), False),
    "wiener": (StepParams(tau_match=400.0, n_sim=8, n_search=4, n_disp=1,
                          k=8, p=3), True),
    "ht-flat-pang": (StepParams(tau_match=2500.0, n_sim=8, n_search=4,
                                n_disp=1, k=8, p=4, p_ang=2, flat_tau=1.3),
                     False),
    "wiener-flat-pang": (StepParams(tau_match=400.0, n_sim=8, n_search=4,
                                    n_disp=1, k=8, p=4, p_ang=2,
                                    flat_tau=1.3), True),
    "ht-sd-bior-hadamard": (StepParams(tau_match=2500.0, n_sim=4,
                                       n_search=3, n_disp=1, k=8, p=4,
                                       tau_2d="bior", tau_5d="hadamard",
                                       use_sd=True), False),
}


@pytest.fixture(scope="module")
def lf_pair():
    """Half-flat content, so flat_tau masks some groups and not others."""
    clean = synthetic_lf_multi(AH, AW, H, W, C, disps=(0.0, 2.0), seed=0,
                               blob_frac=0.25, flat_frac=0.4)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    return noisy, clean + add_noise_np(np.zeros_like(clean), 3.0, seed=2)


def _inputs(sp, noisy, basic, wiener):
    xp = tden._flat_pad(torch.as_tensor(noisy), sp.pad)
    bp = tden._flat_pad(torch.as_tensor(basic), sp.pad) if wiener else None
    mp = bp if wiener else xp
    sig = tden._sigma_channels(SIGMA, "rgb", C, "float64")
    return xp, mp, sig, bp


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", ["kernel-step", "dense"])
def test_step_num_den_match_reference(lf_pair, case, engine):
    sp, wiener = CASES[case]
    tsp = from_reference(sp)
    lam = 0.0 if wiener else 2.7
    noisy, basic = lf_pair
    xp, mp, sig, bp = _inputs(sp, noisy, basic, wiener)
    if engine == "kernel-step":
        step = build_kernel_step(tsp, lam, AH, AW, H, W, C, wiener,
                                 "float64", "cpu")
    else:
        step = tden._build_step(tsp, lam, AH, AW, H, W, C, 64, wiener,
                                "float64")
    num, den = step(xp, mp, sig, bp)
    jstep = jden._build_step(sp, lam, AH, AW, H, W, C, 64, wiener, "float64")
    jnum, jden_ = jstep(jnp.asarray(xp.numpy()), jnp.asarray(mp.numpy()),
                       jnp.asarray(sig.numpy()),
                       None if bp is None else jnp.asarray(bp.numpy()))
    assert num.shape == (AH * AW, H + 2 * sp.pad, W + 2 * sp.pad, C)
    np.testing.assert_allclose(num.numpy(), np.asarray(jnum), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden_), rtol=0,
                               atol=1e-9)
    if sp.flat_tau > 0:
        assert (den.numpy() == 0).any() and (den.numpy() > 0).any()


def test_kaiser_conv_spreads_origin_weights():
    """One weight at a patch origin becomes the k x k Kaiser window."""
    from lfbm5d_torch.transforms.matrices import kaiser_window

    w = torch.zeros((1, 1, 20, 20), dtype=torch.float64)
    w[0, 0, 5, 7] = 2.0
    den = kaiser_conv(w, 8)
    want = np.zeros((20, 20))
    want[5:13, 7:15] = 2.0 * kaiser_window(8)
    np.testing.assert_allclose(den[0, 0].numpy(), want, rtol=0, atol=1e-15)


def test_group_tables_packing():
    """The kernels' constant-memory layout (csrc/group_stage.cuh::Tables):
    f2 i2 kaiser, four 19x19 angular slots, two 341-float stack slots."""
    sp = from_reference(CASES["ht"][0])
    t = GroupTables.build(sp, 3, 5)
    assert t.packed.dtype == torch.float32
    assert t.packed.numel() == 3 * 64 + 4 * 361 + 2 * 341
    np.testing.assert_array_equal(t.packed[:64].numpy(),
                                  t.gt.f2.reshape(-1).numpy())
    np.testing.assert_array_equal(t.packed[128:192].numpy(),
                                  t.kaiser.reshape(-1).numpy())
    f4t = 192 + 2 * 361
    np.testing.assert_array_equal(t.packed[f4t:f4t + 25].numpy(),
                                  t.gt.f4t.reshape(-1).numpy())
    assert not t.packed[f4t + 25:f4t + 361].any()
    stf = 192 + 4 * 361
    for lv in range(4):  # sizes 1, 2, 4, 8 at (s*s - 1)/3, [s][s]
        s = 1 << lv
        off = stf + (s * s - 1) // 3
        np.testing.assert_array_equal(
            t.packed[off:off + s * s].numpy(),
            t.gt.stack_f[lv, :s, :s].reshape(-1).numpy())
    tid = GroupTables.build(sp.replace(tau_4d="id"), 3, 5)
    np.testing.assert_array_equal(tid.packed[192:201].numpy(),
                                  np.eye(3, dtype=np.float32).reshape(-1))


def test_group_wrapper_raises_off_cpu_without_cuda():
    """A non-CPU tensor never falls back to the plain version."""
    sp = from_reference(CASES["ht"][0])
    meta = torch.empty((C, AH * AW, 34, 42), device="meta")
    tables = GroupTables.build(sp, AH, AW, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_group_step(meta, None, meta, meta, meta, meta, meta, 0, meta,
                         tables, meta, meta, k=8, nd=1, lambda_3d=2.7,
                         wiener=False)


def test_plain_group_step_accumulates_in_place(lf_pair):
    """Two references accumulate into the same num/wden tensors."""
    sp = from_reference(CASES["ht"][0])
    noisy, _ = lf_pair
    xp, mp, sig, _ = _inputs(sp, noisy, None, False)
    step = build_kernel_step(sp, 2.7, AH, AW, H, W, C, False, "float64",
                             "cpu")
    noisy_pl = xp.permute(3, 0, 1, 2).contiguous()
    num = torch.zeros_like(noisy_pl)
    wden = torch.zeros_like(noisy_pl)
    match0 = mp[..., 0].contiguous()
    sums = []
    for r in (0, 4):
        sim_y, sim_x, lvl, mask, bidx = step.block_match(match0, r, None)
        fused_group_step(noisy_pl, None, bidx, sim_y, sim_x, lvl, mask, r,
                         sig, step.tables, num, wden, k=8, nd=1,
                         lambda_3d=2.7, wiener=False)
        sums.append(float(wden.sum()))
    assert 0 < sums[0] < sums[1]
    assert fused_group_step.launches == 0
