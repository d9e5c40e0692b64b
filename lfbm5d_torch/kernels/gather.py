"""Sampling of the disparity argmin maps: the per-slot doff table.

`sample_doff` is the plain version of `lfbm5d_tpu/kernels/gather.py::
sample_doff` (TPU kernel, per-tile band DMA of the argmin table + per-slot
row reads). On the card there is no standalone kernel for it: the group
kernels (`csrc/group_stage.cuh`, `csrc/twokernel.cu`) read
`bidx[a, sim_y, sim_x]` themselves in their prologue, so in the step's
`direct` mode the [T, N, A] table is never written to device memory.

`gather_rows` replaces `lfbm5d_tpu/kernels/gather.py::gather_rows` (TPU: one
row DMA per index, `depth` copies in flight; csrc/gather.cu): out[s] =
table[idx[s]]. The step's `take` and `dma` modes (pipeline/engine.py) build
the [T, N, A] table with it from the [V0*V1, A] transposed argmin maps and
hand it to the group kernels as `doff`. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from lfbm5d_torch.kernels._build import check, library, require, stream_of


def sample_doff(bidx: torch.Tensor, sim_y: torch.Tensor, sim_x: torch.Tensor,
                ref: int, c_ang: int) -> torch.Tensor:
    """bidx: [A, V0, V1] argmin maps of one reference; sim_y/sim_x: [T, N]
    similar-patch positions. Returns [T, N, A] displacement indices; the
    reference SAI's own lane is the centered displacement c_ang (its angular
    match is the similar patch itself)."""
    ang = bidx[:, sim_y, sim_x]  # [A, T, N]
    ang[ref] = c_ang
    return ang.permute(1, 2, 0)


def slot_doff(bidx, sim_y, sim_x, ref: int, c_ang: int, doff=None):
    """The [T, N, A] displacement indices a group stage uses: sampled from
    bidx (doff None), or the given per-slot table; the reference SAI's lane
    is c_ang in both (the group kernels substitute it the same way)."""
    if doff is None:
        return sample_doff(bidx, sim_y.long(), sim_x.long(), ref, c_ang)
    if doff.shape != (*sim_y.shape, bidx.shape[0]):
        raise ValueError(f"doff {tuple(doff.shape)} vs slots "
                         f"{tuple(sim_y.shape)} of {bidx.shape[0]} SAIs")
    ang = doff.clone()
    ang[..., ref] = c_ang
    return ang


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the row gather; raises on an index out of range."""
    return table.index_select(0, idx.long())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s] = table[idx[s]] for a [V, W] int32 or float32 table and int32
    idx [S]; returns [S, W]. CPU tensors run the plain version; CUDA tensors
    launch the kernel, which neither clamps nor checks the indices: they
    are the caller's guarantee to lie in [0, V), as in the reference."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"gather_rows takes int32 or float32 tables, got "
                         f"{table.dtype}")
    require(table, "table", table.dtype, 2)
    require(idx, "idx", torch.int32, 1, table.device)
    s, w = idx.shape[0], table.shape[1]
    out = torch.empty((s, w), dtype=table.dtype, device=table.device)
    if s == 0 or w == 0:
        return out
    with torch.cuda.device(table.device):
        rc = library().lfbm5d_gather_rows(table.data_ptr(), idx.data_ptr(),
                                          out.data_ptr(), s, w,
                                          stream_of(table))
    check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
