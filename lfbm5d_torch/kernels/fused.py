"""Group-stage kernel (csrc/fused.cu) and its plain version.

`fused_group_step` replaces lfbm5d_tpu/kernels/fused.py::fused_group_step
(and, folded into its prologue, lfbm5d_tpu/kernels/gather.py::sample_doff):
for every reference patch t of one reference SAI it extracts the 5D group at
the similar-patch positions and their per-SAI disparity offsets, runs the
forward transform chain, HT or Wiener shrinkage, the inverse chain, and adds
the weighted estimate into the numerator.

Contract (kernel and plain version alike), on the kernel's planar layout:
  noisy, basic   [C, A, Hp, Wp]   padded LF planes (basic: Wiener only)
  bidx           [A, V0, V1]      disparity argmin maps of this reference
  sim_y, sim_x   [T, N]           similar-patch positions (padded coords)
  lvl [T], mask [T, N]            stack level and live slots (flat groups and
                                  slots beyond 2**lvl are masked)
  num  += est * w * kaiser        at every patch pixel
  wden += w                       at every patch ORIGIN: the denominator is
                                  deferred; den = Kaiser convolution of wden
                                  (pipeline/engine.py), which equals the
                                  reference's direct den.
The kernel adds with f32 atomics in no fixed order, so it agrees with the
plain version to f32 rounding (relative 1e-4 on the accumulators; an HT
coefficient within rounding of the threshold may flip, which moves one
group). `launches` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lfbm5d_tpu.config import StepParams
from lfbm5d_torch.kernels._build import check, library, require, stream_of
from lfbm5d_torch.kernels.gather import sample_doff
from lfbm5d_torch.ops.distances import center_index, displacements
from lfbm5d_torch.ops.shrinkage import filter_groups
from lfbm5d_torch.transforms import matrices as tm
from lfbm5d_torch.transforms.apply import GroupTransforms

_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
_CHUNK = 256  # groups per gather in the plain version (memory bound only)


@dataclass(frozen=True)
class GroupTables:
    """Transform constants of one step: the plain version's GroupTransforms
    and Kaiser window, and the same tables packed for the kernel."""

    gt: GroupTransforms
    kaiser: torch.Tensor  # [k, k]
    packed: torch.Tensor  # f32: f2 i2 f4s i4s f4t i4t stack_f stack_i kaiser
    a_h: int
    a_w: int

    @staticmethod
    def build(sp: StepParams, a_h: int, a_w: int, dtype=torch.float32,
              device="cpu") -> "GroupTables":
        gt = GroupTransforms.build(sp, a_h, a_w, dtype=dtype, device=device)
        kai = torch.as_tensor(tm.kaiser_window(sp.k), dtype=dtype,
                              device=device)

        def ang(m, size):
            if m is None:
                return torch.eye(size, dtype=dtype, device=device)
            return m

        parts = (gt.f2, gt.i2, ang(gt.f4s, a_h), ang(gt.i4s, a_h),
                 ang(gt.f4t, a_w), ang(gt.i4t, a_w), gt.stack_f, gt.stack_i,
                 kai)
        packed = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
        return GroupTables(gt, kai, packed.contiguous(), a_h, a_w)


def fused_group_step_plain(noisy, basic, bidx, sim_y, sim_x, lvl, mask,
                           ref: int, sigma_c, tables: GroupTables, num, wden,
                           *, k: int, nd: int, lambda_3d: float,
                           wiener: bool, use_sd: bool = False) -> None:
    """Plain torch version of the group kernel (same contract, in place)."""
    c, a, _, _ = noisy.shape
    t, n_sim = sim_y.shape
    gt, a_h, a_w = tables.gt, tables.a_h, tables.a_w
    dev = noisy.device
    disp_ang = torch.as_tensor(displacements(nd), dtype=torch.long, device=dev)
    ang = sample_doff(bidx, sim_y.long(), sim_x.long(), ref, center_index(nd))
    ku = torch.arange(k, device=dev)[:, None]
    kv = torch.arange(k, device=dev)[None, :]
    a_b = torch.arange(a, device=dev)[None, None, :, None, None]
    a_o = a_b[..., 0, 0]  # [1, 1, A]
    # channel-last views of the planar tensors: same gathers as the dense step
    nv = noisy.permute(1, 2, 3, 0)
    bv = basic.permute(1, 2, 3, 0) if wiener else None
    numv = num.permute(1, 2, 3, 0)
    wdv = wden.permute(1, 2, 3, 0)
    for s0 in range(0, t, _CHUNK):
        s1 = min(t, s0 + _CHUNK)
        tc = s1 - s0
        clvl = lvl[s0:s1].long()
        aoff = disp_ang[ang[s0:s1].long()]  # [Tc, N, A, 2]
        ay = sim_y[s0:s1, :, None].long() + aoff[..., 0]
        ax = sim_x[s0:s1, :, None].long() + aoff[..., 1]
        yy = ay[..., None, None] + ku
        xx = ax[..., None, None] + kv
        shape = (tc, n_sim, a_h, a_w, k, k, c)
        g = nv[a_b, yy, xx].reshape(shape)
        gb = bv[a_b, yy, xx].reshape(shape) if wiener else None
        est, wgt = filter_groups(g, gb, clvl, gt, sigma_c, lambda_3d, use_sd)
        est = est.reshape(tc, n_sim, a, k, k, c)
        wm = wgt[:, None, :] * mask[s0:s1, :, None]  # [Tc, N, C]
        wfull = wm[:, :, None, None, None, :] * tables.kaiser[..., None]
        numv.index_put_((a_b, yy, xx), est * wfull, accumulate=True)
        wdv.index_put_((a_o, ay, ax),
                       wm[:, :, None, :].expand(tc, n_sim, a, c),
                       accumulate=True)


def fused_group_step(noisy, basic, bidx, sim_y, sim_x, lvl, mask, ref: int,
                     sigma_c, tables: GroupTables, num, wden, *, k: int,
                     nd: int, lambda_3d: float, wiener: bool,
                     use_sd: bool = False) -> None:
    """One reference SAI's group stage, accumulated into num/wden in place
    (contract in the module docstring). CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    if noisy.device.type == "cpu":
        return fused_group_step_plain(
            noisy, basic, bidx, sim_y, sim_x, lvl, mask, ref, sigma_c, tables,
            num, wden, k=k, nd=nd, lambda_3d=lambda_3d, wiener=wiener,
            use_sd=use_sd,
        )
    dev = noisy.device
    f32 = torch.float32
    require(noisy, "noisy", f32, 4)
    c, a, hp, wp = noisy.shape
    if wiener:
        require(basic, "basic", f32, 4, dev)
        if basic.shape != noisy.shape:
            raise ValueError("basic and noisy differ in shape")
    require(bidx, "bidx", torch.int32, 3, dev)
    require(sim_y, "sim_y", torch.int32, 2, dev)
    require(sim_x, "sim_x", torch.int32, 2, dev)
    require(lvl, "lvl", torch.int32, 1, dev)
    require(mask, "mask", torch.bool, 2, dev)
    require(sigma_c, "sigma_c", f32, 1, dev)
    require(num, "num", f32, 4, dev)
    require(wden, "wden", f32, 4, dev)
    require(tables.packed, "tables.packed", f32, 1, dev)
    t, n_sim = sim_y.shape
    if t == 0:
        return
    a_h, a_w = tables.a_h, tables.a_w
    v0, v1 = hp - k + 1, wp - k + 1
    if k != 8:
        raise ValueError(f"group kernel is built for k=8, got k={k}")
    if use_sd:
        raise ValueError("group kernel does not take use_sd weights")
    if n_sim > 16 or a_h > 16 or a_w > 16:
        raise ValueError(f"group kernel takes N, aH, aW <= 16; got N={n_sim}, "
                         f"{a_h}x{a_w}")
    if (bidx.shape != (a, v0, v1) or sim_x.shape != (t, n_sim)
            or lvl.shape != (t,) or mask.shape != (t, n_sim)
            or sigma_c.shape != (c,) or num.shape != noisy.shape
            or wden.shape != noisy.shape or a_h * a_w != a):
        raise ValueError("group kernel: inconsistent shapes")
    lib = library()
    smem = lib.lfbm5d_group_smem_bytes(n_sim, a, a_h, a_w)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"group kernel: N={n_sim}, A={a} needs {smem} bytes of shared "
            f"memory per block, over the {_MAX_SMEM} a block may use"
        )
    grid = min(t, torch.cuda.get_device_properties(dev).multi_processor_count)
    work = (torch.empty((grid, k * k * n_sim * a), dtype=f32, device=dev)
            if wiener else None)
    rc = lib.lfbm5d_group_step(
        noisy.data_ptr(), basic.data_ptr() if wiener else None,
        bidx.data_ptr(), sim_y.data_ptr(), sim_x.data_ptr(), lvl.data_ptr(),
        mask.data_ptr(), sigma_c.data_ptr(), tables.packed.data_ptr(),
        num.data_ptr(), wden.data_ptr(),
        work.data_ptr() if wiener else None, t, n_sim, a, a_h,
        a_w, c, hp, wp, v0, v1, nd, ref, int(wiener), float(lambda_3d), grid,
        stream_of(noisy),
    )
    check(rc, "fused_group_step")
    fused_group_step.launches += 1


fused_group_step.launches = 0
