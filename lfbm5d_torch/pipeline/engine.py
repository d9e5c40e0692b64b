"""Kernel-backed filtering step: the GPU-native group path.

Same contract as `pipeline.denoise._build_step` (one HT or Wiener pass over
all reference SAIs, returning padded numerator/denominator accumulators
[A, Hp, Wp, C]); counterpart of `lfbm5d_tpu.pipeline.engine.
build_kernel_step` without its TPU machinery (tiling, 128-lane layouts, SMEM
packing, reference batching). Per reference SAI on the p_ang grid:

  self-BM kernel -> select_similar (torch; flat groups masked) ->
  cross-argmin kernel against all A planes -> the group stage of the route

The route is fixed once per step, from shapes and parameters alone
(`resolve_route`), before anything launches:

  fused       the group kernel with the group in shared memory
              (kernels/fused.py::fused_group_step): k = 8, no use_sd,
              N <= 16, aH, aW <= 16 and group_smem_bytes <= 232,448;
  banked      the same stage for the larger groups, each spread over the
              shared memory of a thread-block cluster
              (fused_group_step_banked): otherwise k = 8, no use_sd,
              N <= 16, A <= 384, aH, aW <= 19;
  two_kernel  everything else, or fused=False: chunks of groups through
              extract_groups -> transforms/flat.py (torch matmuls) -> HT or
              Wiener shrink (ops/shrinkage.py) -> inverse ->
              accumulate_groups_fused.

The disparity sampling of the group stage follows `doff_mode`, as the
reference's LFBM5D_DOFF_MODE does (passed here as an argument, so it is part
of the builder's cache key):

  direct      (default) the group kernels read bidx[a, sim_y, sim_x] in
              their prologue;
  take, dma   the [V0*V1, A] table bidx.view(A, -1).t() is gathered at rows
              sim_y*V1 + sim_x of every slot into doff [T, N, A], which the
              group stage reads instead: `take` by the plain gather
              (index_select, the reference's jnp.take), `dma` by the
              gather_rows kernel (kernels/gather.py).

All three give the group stage the same integers, so the same num/den.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors. The group stage works on planar [C, A, Hp, Wp]
copies of the LF. The fused and banked routes accumulate the denominator
DEFERRED (the weight at each patch origin; `kaiser_conv` turns it into the
reference's den once per step); the two-kernel route adds the den directly,
as the reference's two-kernel path does. Flat groups stay masked on every
route (they exit the group kernels at once; on two_kernel their slots carry
zero weight), and no route reads a count back to the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lfbm5d_torch.config import StepParams
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.kernels.accumulate import accumulate_groups_fused
from lfbm5d_torch.kernels.bm import (
    cross_argmin_all_kernel,
    self_distances_kernel,
)
from lfbm5d_torch.kernels.extract import extract_groups
from lfbm5d_torch.kernels.fused import (
    GroupTables,
    banked_fits,
    fused_group_step,
    fused_group_step_banked,
    group_fits,
)
from lfbm5d_torch.kernels.gather import gather_rows, gather_rows_plain
from lfbm5d_torch.lf.pad import ind_initialize, ref_sai_grid
from lfbm5d_torch.ops.distances import displacements
from lfbm5d_torch.ops.flat import flat_ref_mask
from lfbm5d_torch.ops.match import select_similar
from lfbm5d_torch.ops.shrinkage import ht_shrink, sd_weight, wiener_shrink
from lfbm5d_torch.transforms import matrices as tm
from lfbm5d_torch.transforms.flat import (
    FlatTransforms,
    forward_flat,
    inverse_flat,
)

# Bytes of one two-kernel chunk's group tensor (all channels of one plane
# set); about eight such tensors are alive at once.
TWO_KERNEL_CHUNK_BYTES = 1 << 29
DOFF_MODES = ("direct", "take", "dma")


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


def resolve_route(sp: StepParams, a_h: int, a_w: int,
                  fused: bool | None = None) -> str:
    """The step's route (module docstring). fused=None picks by shape;
    True forces the fused family and raises where neither group kernel
    takes the shape; False forces two_kernel."""
    if fused is False:
        return "two_kernel"
    if group_fits(sp, a_h, a_w):
        return "fused"
    if banked_fits(sp, a_h, a_w):
        return "banked"
    if fused:
        raise ValueError(
            f"fused=True: no group kernel takes k={sp.k}, use_sd={sp.use_sd},"
            f" N={sp.n_sim} at {a_h}x{a_w} SAIs")
    return "two_kernel"


@lru_cache(maxsize=None)
def build_kernel_step(sp: StepParams, lambda_3d: float, a_h: int, a_w: int,
                      h: int, w: int, c: int, wiener: bool,
                      dtype: str = "float32", device: str | None = None,
                      fused: bool | None = None, doff_mode: str = "direct"):
    """Returns fn(noisy_p, match_p, sigma_c, basic_p) -> (num, den), with
    fn.route its route: 'fused', 'banked' or 'two_kernel'. device None is
    the CUDA card (raises without one)."""
    k, n, nd, n_sim, pad = sp.k, sp.n_search, sp.n_disp, sp.n_sim, sp.pad
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    if doff_mode not in DOFF_MODES:
        raise ValueError(f"doff_mode must be one of {DOFF_MODES}, got "
                         f"{doff_mode!r}")
    dev = resolve_device(device)
    a = a_h * a_w
    v1 = w + 2 * pad - k + 1  # argmin map width
    route = resolve_route(sp, a_h, a_w, fused)
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
        group stage's inputs."""
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

    def slot_table(bidx, sim_y, sim_x):
        """doff [T, N, A] of the take and dma modes (None when direct):
        rows sim_y*V1 + sim_x of the [V0*V1, A] transposed argmin maps."""
        if doff_mode == "direct":
            return None
        table = bidx.view(a, -1).t().contiguous()
        rows = (sim_y * v1 + sim_x).view(-1)
        gather = gather_rows if doff_mode == "dma" else gather_rows_plain
        return gather(table, rows).view(*sim_y.shape, a)

    if route == "two_kernel":
        ft = FlatTransforms.build(sp, a_h, a_w, dtype=dt, device=dev)
        kai = tables.kaiser.reshape(-1)
        group_bytes = c * n_sim * k * k * a * dt.itemsize
        chunk = max(1, TWO_KERNEL_CHUNK_BYTES // group_bytes)

        def canon(x, g):
            """Flat [C*G, N, k*k, A] as a view [G, N, aH, aW, k, k, C]."""
            return x.view(c, g, n_sim, k, k, a_h, a_w).permute(
                1, 2, 5, 6, 3, 4, 0)

        def group_stage(noisy_pl, basic_pl, bidx, doff, sim_y, sim_x, lvl,
                        mask, r, sigma_c, num, den):
            """Chunks of groups: extract -> flat transforms -> shrink ->
            inverse -> accumulate (direct den)."""
            t = sim_y.shape[0]
            for g0 in range(0, t, chunk):
                sl = slice(g0, min(t, g0 + chunk))
                sy, sx, mk, lv = sim_y[sl], sim_x[sl], mask[sl], lvl[sl]
                dc = None if doff is None else doff[sl]
                g = sy.shape[0]
                lv_c = lv.long().repeat(c)  # rows ordered (channel, group)
                grp = extract_groups(noisy_pl, bidx, sy, sx, mk, r, k=k,
                                     nd=nd, doff=dc)
                spec = forward_flat(grp.view(c * g, n_sim, k * k, a), lv_c,
                                    ft)
                if wiener:
                    grp_b = extract_groups(basic_pl, bidx, sy, sx, mk, r,
                                           k=k, nd=nd, doff=dc)
                    spec_b = forward_flat(
                        grp_b.view(c * g, n_sim, k * k, a), lv_c, ft)
                    filt, wgt = wiener_shrink(canon(spec, g),
                                              canon(spec_b, g), sigma_c)
                else:
                    filt, wgt = ht_shrink(canon(spec, g), sigma_c, lambda_3d)
                est = inverse_flat(
                    filt.permute(6, 0, 1, 4, 5, 2, 3).reshape(
                        c * g, n_sim, k * k, a), lv_c, ft)
                if sp.use_sd:
                    wgt = sd_weight(canon(est, g), lv, a, k)
                wm = wgt.T[:, :, None] * mk[None]  # [C, G, N]
                vals = est.view(c, g, n_sim, k * k, a) * (
                    wm[..., None, None] * kai[:, None])
                accumulate_groups_fused(vals, wm.contiguous(), kai, bidx, sy,
                                        sx, mk, r, num, den, k=k, nd=nd,
                                        doff=dc)
    else:
        group_fn = (fused_group_step if route == "fused"
                    else fused_group_step_banked)

        def group_stage(noisy_pl, basic_pl, bidx, doff, sim_y, sim_x, lvl,
                        mask, r, sigma_c, num, wden):
            group_fn(noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask, r,
                     sigma_c, tables, num, wden, k=k, nd=nd,
                     lambda_3d=lambda_3d, wiener=wiener, use_sd=sp.use_sd,
                     doff=doff)

    def step(noisy_p, match_p, sigma_c, basic_p):
        match0 = match_p[..., 0].contiguous()  # [A, Hp, Wp]
        noisy_pl = noisy_p.permute(3, 0, 1, 2).contiguous()  # [C, A, Hp, Wp]
        basic_pl = basic_p.permute(3, 0, 1, 2).contiguous() if wiener else None
        fmask = flat_mask(noisy_pl, sigma_c)
        num = torch.zeros_like(noisy_pl)
        den = torch.zeros_like(noisy_pl)
        for r in refs:
            sim_y, sim_x, lvl, mask, bidx = block_match(match0, r, fmask)
            doff = slot_table(bidx, sim_y, sim_x)
            group_stage(noisy_pl, basic_pl, bidx, doff, sim_y, sim_x, lvl,
                        mask, r, sigma_c, num, den)
        if route != "two_kernel":
            den = kaiser_conv(den, k)
        return num.permute(1, 2, 3, 0), den.permute(1, 2, 3, 0)

    step.route = route
    step.flat_mask = flat_mask
    step.block_match = block_match
    step.slot_table = slot_table
    step.tables = tables
    step.refs = refs
    return step
