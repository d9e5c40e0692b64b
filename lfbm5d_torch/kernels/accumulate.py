"""Aggregation of the two-kernel path (csrc/twokernel.cu) and its plain
versions.

`accumulate_groups_fused` replaces lfbm5d_tpu/kernels/accumulate.py::
accumulate_groups_fused and `accumulate_groups` replaces ::accumulate_groups
(TPU: sequential read-modify-write of per-tile A-on-lanes bands through a
per-lane placement mux). Contract, the inverse of `kernels.extract`:
  vals          [P, G, N, k*k, A]  weighted patch values (est * w * kaiser)
  wv            [P, G, N]          per-slot weights (fused form only)
  kaiser        [k*k]              the Kaiser window (fused form only)
  bidx, sim_y, sim_x, mask, ref    as for extract_groups, and doff (optional)
  num [P, A, Hp, Wp] += vals at every patch pixel's plane position
  den [P, A, Hp, Wp] += wv * kaiser[pix] at the same positions (fused form)
Both in place; masked slots add nothing. The den is direct, as the
reference's two-kernel path has it (its deferred den belongs to the fused
kernels). One kernel serves both forms (without den: a template flag). It
adds by f32 reductions in no fixed order, so it agrees with the plain
versions to f32 rounding (relative 1e-5). What bounds it on the card: the
reductions in L2, about one request per 32-byte sector a warp touches (the
csrc/twokernel.cu header); its launch plan is
`kernels.extract.twokernel_plan`. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from lfbm5d_torch.kernels._build import check, library, require, stream_of
from lfbm5d_torch.kernels.extract import check_geometry, patch_coords


def _scatter_plain(acc, src, yy, xx, a_i):
    p = acc.shape[0]
    p_i = torch.arange(p, device=acc.device)[:, None, None, None, None]
    acc.index_put_((p_i, a_i, yy, xx), src.expand(p, *yy.shape),
                   accumulate=True)


def accumulate_groups_fused_plain(vals, wv, kaiser, bidx, sim_y, sim_x, mask,
                                  ref: int, num, den, *, k: int, nd: int,
                                  doff=None) -> None:
    """Plain torch version of the fused (num + den) form."""
    yy, xx, a_i = patch_coords(bidx, sim_y, sim_x, ref, k, nd, doff)
    m = mask[None, :, :, None, None]
    _scatter_plain(num, torch.where(m, vals, 0.0), yy, xx, a_i)
    dv = wv[..., None, None] * kaiser[:, None]  # [P, G, N, k*k, 1]
    _scatter_plain(den, torch.where(m, dv, 0.0), yy, xx, a_i)


def accumulate_groups_plain(vals, bidx, sim_y, sim_x, mask, ref: int, num,
                            *, k: int, nd: int, doff=None) -> None:
    """Plain torch version of the num-only form."""
    yy, xx, a_i = patch_coords(bidx, sim_y, sim_x, ref, k, nd, doff)
    _scatter_plain(num, torch.where(mask[None, :, :, None, None], vals, 0.0),
                   yy, xx, a_i)


def _launch(vals, wv, kaiser, bidx, sim_y, sim_x, mask, ref, num, den, k,
            nd, doff, what):
    dev = vals.device
    f32 = torch.float32
    require(vals, "vals", f32, 5)
    require(num, "num", f32, 4, dev)
    check_geometry(num, bidx, sim_y, sim_x, mask, k, nd, doff)
    p, a, hp, wp = num.shape
    g, n = sim_y.shape
    if vals.shape != (p, g, n, k * k, a):
        raise ValueError(f"{what}: vals {tuple(vals.shape)} vs "
                         f"{(p, g, n, k * k, a)}")
    if den is not None:
        require(den, "den", f32, 4, dev)
        require(wv, "wv", f32, 3, dev)
        require(kaiser, "kaiser", f32, 1, dev)
        if (den.shape != num.shape or wv.shape != (p, g, n)
                or kaiser.shape != (k * k,)):
            raise ValueError(f"{what}: inconsistent den, wv or kaiser shape")
    if g == 0:
        return False
    with torch.cuda.device(dev):
        rc = library().lfbm5d_accumulate_groups(
            vals.data_ptr(), None if den is None else wv.data_ptr(),
            None if den is None else kaiser.data_ptr(), bidx.data_ptr(),
            None if doff is None else doff.data_ptr(), sim_y.data_ptr(),
            sim_x.data_ptr(), mask.data_ptr(), num.data_ptr(),
            None if den is None else den.data_ptr(), g * n, p, a, hp, wp,
            hp - k + 1, wp - k + 1, k, nd, ref, stream_of(vals),
        )
    check(rc, what)
    return True


def accumulate_groups_fused(vals, wv, kaiser, bidx, sim_y, sim_x, mask,
                            ref: int, num, den, *, k: int, nd: int,
                            doff=None) -> None:
    """num += vals and den += wv * kaiser at every patch pixel (contract in
    the module docstring). CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    if vals.device.type == "cpu":
        return accumulate_groups_fused_plain(
            vals, wv, kaiser, bidx, sim_y, sim_x, mask, ref, num, den, k=k,
            nd=nd, doff=doff)
    if den is None:
        raise ValueError("accumulate_groups_fused: den is required")
    if _launch(vals, wv, kaiser, bidx, sim_y, sim_x, mask, ref, num, den, k,
               nd, doff, "accumulate_groups_fused"):
        accumulate_groups_fused.launches += 1


def accumulate_groups(vals, bidx, sim_y, sim_x, mask, ref: int, num, *,
                      k: int, nd: int, doff=None) -> None:
    """num += vals at every patch pixel (the num-only form). CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if vals.device.type == "cpu":
        return accumulate_groups_plain(vals, bidx, sim_y, sim_x, mask, ref,
                                       num, k=k, nd=nd, doff=doff)
    if _launch(vals, None, None, bidx, sim_y, sim_x, mask, ref, num, None, k,
               nd, doff, "accumulate_groups"):
        accumulate_groups.launches += 1


accumulate_groups_fused.launches = 0
accumulate_groups.launches = 0
