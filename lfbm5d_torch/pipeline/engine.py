"""Kernel-backed filtering step: the GPU-native group path.

Same contract as `pipeline.denoise._build_step` (one HT or Wiener pass over
all reference SAIs, returning padded numerator/denominator accumulators
[A, Hp, Wp, C]); counterpart of `lfbm5d_tpu.pipeline.engine.
build_kernel_step` without its TPU machinery (tiling, 128-lane layouts, SMEM
packing, reference batching). Per reference SAI on the p_ang grid:

  self-BM kernel -> select_similar (torch; flat groups masked) ->
  cross-argmin kernel against all A planes -> group kernel

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors. The group stage works on planar [C, A, Hp, Wp]
copies of the LF and accumulates the denominator DEFERRED (the weight at
each patch origin); `kaiser_conv` turns it into the reference's den once per
step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lfbm5d_tpu.config import StepParams
from lfbm5d_torch.kernels.bm import (
    cross_argmin_all_kernel,
    self_distances_kernel,
)
from lfbm5d_torch.kernels.fused import GroupTables, fused_group_step
from lfbm5d_torch.lf.pad import ind_initialize, ref_sai_grid
from lfbm5d_torch.ops.distances import displacements
from lfbm5d_torch.ops.flat import flat_ref_mask
from lfbm5d_torch.ops.match import select_similar
from lfbm5d_torch.transforms import matrices as tm


def kaiser_conv(wden: torch.Tensor, k: int) -> torch.Tensor:
    """Deferred denominator -> den: separable k-tap Kaiser convolution over
    the spatial axes of [C, A, Hp, Wp] (a patch origin's weight spreads over
    the patch's k x k pixels, as kaiser_window = outer(w1, w1))."""
    w1 = [float(v) for v in tm.kaiser_window_1d(k)]
    h, w = wden.shape[-2:]
    x = wden
    acc = x * w1[0]
    for i in range(1, k):
        acc = acc + F.pad(x[..., :h - i, :], (0, 0, i, 0)) * w1[i]
    x = acc
    acc = x * w1[0]
    for i in range(1, k):
        acc = acc + F.pad(x[..., :w - i], (i, 0)) * w1[i]
    return acc


@lru_cache(maxsize=None)
def build_kernel_step(sp: StepParams, lambda_3d: float, a_h: int, a_w: int,
                      h: int, w: int, c: int, wiener: bool,
                      dtype: str = "float32", device: str = "cpu"):
    """Returns fn(noisy_p, match_p, sigma_c, basic_p) -> (num, den)."""
    k, n, nd, n_sim, pad = sp.k, sp.n_search, sp.n_disp, sp.n_sim, sp.pad
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    dev = torch.device(device)
    ys = ind_initialize(h, k, sp.p) + pad
    xs = ind_initialize(w, k, sp.p) + pad
    ys_d = torch.as_tensor(ys, dtype=torch.long, device=dev)
    xs_d = torch.as_tensor(xs, dtype=torch.long, device=dev)
    pos_y = torch.as_tensor(np.repeat(ys, len(xs)), device=dev)
    pos_x = torch.as_tensor(np.tile(xs, len(ys)), device=dev)
    disp_self = torch.as_tensor(displacements(n), device=dev)  # int32
    tables = GroupTables.build(sp, a_h, a_w, dtype=dt, device=dev)
    refs = [int(r) for r in ref_sai_grid(a_h, a_w, sp.p_ang)]

    def flat_mask(noisy_pl, sigma_c):
        """[T] bool redundant reference positions (None when flat_tau is
        off), from the NOISY planes in both steps (ops/flat.py)."""
        if sp.flat_tau <= 0:
            return None
        return flat_ref_mask(noisy_pl[0], ys_d, xs_d, k, sp.flat_tau,
                             sigma_c[0])

    def block_match(match0, r: int, fmask):
        """BM of reference SAI r: (sim_y, sim_x, lvl, mask, bidx), the
        group kernel's inputs."""
        im = match0[r]
        d_self = self_distances_kernel(im, ys, xs, k, n)  # [T, Ds]
        order, lvl, mask = select_similar(d_self, n, sp.tau_match, n_sim)
        if fmask is not None:
            mask = mask & ~fmask[:, None]
        off = disp_self[order]  # [T, N, 2]
        sim_y = (pos_y[:, None] + off[..., 0]).contiguous()
        sim_x = (pos_x[:, None] + off[..., 1]).contiguous()
        bidx = cross_argmin_all_kernel(im, match0, k, nd)  # [A, V0, V1]
        return sim_y, sim_x, lvl, mask, bidx

    def step(noisy_p, match_p, sigma_c, basic_p):
        match0 = match_p[..., 0].contiguous()  # [A, Hp, Wp]
        noisy_pl = noisy_p.permute(3, 0, 1, 2).contiguous()  # [C, A, Hp, Wp]
        basic_pl = basic_p.permute(3, 0, 1, 2).contiguous() if wiener else None
        fmask = flat_mask(noisy_pl, sigma_c)
        num = torch.zeros_like(noisy_pl)
        wden = torch.zeros_like(noisy_pl)
        for r in refs:
            sim_y, sim_x, lvl, mask, bidx = block_match(match0, r, fmask)
            fused_group_step(
                noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask, r, sigma_c,
                tables, num, wden, k=k, nd=nd, lambda_3d=lambda_3d,
                wiener=wiener, use_sd=sp.use_sd,
            )
        den = kaiser_conv(wden, k)
        return num.permute(1, 2, 3, 0), den.permute(1, 2, 3, 0)

    step.flat_mask = flat_mask
    step.block_match = block_match
    step.tables = tables
    step.refs = refs
    return step
