"""Group extraction of the two-kernel path (csrc/twokernel.cu) and its plain
version.

`extract_groups` replaces lfbm5d_tpu/kernels/extract.py::extract_groups
(TPU: per-slot superpatch slice of an A-on-lanes band, per-lane disparity
mux; `kernels/gather.py::sample_doff` beforehand). Contract, on the port's
planar layout:
  planes        [P, A, Hp, Wp]  padded LF planes (e.g. the C channels)
  bidx          [A, V0, V1]     disparity argmin maps of reference SAI `ref`
  doff          [G, N, A]       optional int32 per-slot displacement
                                indices (the step's `take`/`dma` modes)
  sim_y, sim_x  [G, N]          similar-patch positions (padded coords)
  mask          [G, N]          live slots
  returns       [P, G, N, k*k, A]
  out[p, g, n, pix, a] = planes[p, a, sim_y + dy + pix // k,
                                sim_x + dx + pix % k]
with (dy, dx) the displacement of bidx[a, sim_y, sim_x], or of doff[g, n, a]
when it is given (of the centre for a == ref); masked slots are zeros. A
pure gather: the kernel is bit-equal to the plain version. What bounds it
on the card: the bytes of the group tensor it writes (csrc/twokernel.cu
header). `twokernel_plan` is the launch plan of this kernel and of the
accumulate kernel (tests/test_torch_twokernel_tiling.py emulates the
decomposition it describes; chip_smoke.py (a) holds it to the library's).
`launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from lfbm5d_torch.kernels._build import check, library, require, stream_of
from lfbm5d_torch.kernels.fused import SMEM_PER_SM, SMEM_RESERVED
from lfbm5d_torch.kernels.gather import slot_doff
from lfbm5d_torch.ops.distances import center_index, displacements

TK_BLOCKS_PER_SM = 4  # resident blocks per SM the shared stage leaves room for


def twokernel_plan(k: int, a: int) -> tuple[int, int, int, int]:
    """(patch rows per chunk, SAIs per tile, stage pitch in floats, dynamic
    shared bytes) of the extract and accumulate kernels at patch size k and
    A = a SAIs: a copy of csrc/twokernel.cu::make_plan. A block owns one
    (slot, plane) run [k*k, A] of the group tensor and moves it through a
    shared stage [rows*k][pitch] (pitch = tile | 1), chunk by chunk of whole
    patch rows, beside a base table (8 bytes per SAI) and the Kaiser window;
    the budget keeps TK_BLOCKS_PER_SM blocks on an SM. The SAI axis is tiled
    only where one patch row of every SAI does not fit."""
    limit = SMEM_PER_SM // TK_BLOCKS_PER_SM - SMEM_RESERVED
    tile = min(a, (limit - 4 * k * k - 4 * k) // (8 + 4 * k))
    pitch = tile | 1
    rows = min(k, (limit - 8 * tile - 4 * k * k) // (4 * k * pitch))
    return rows, tile, pitch, 8 * tile + 4 * k * k + 4 * rows * k * pitch


def patch_coords(bidx, sim_y, sim_x, ref: int, k: int, nd: int, doff=None):
    """Plane coordinates (y, x) [G, N, k*k, A] of every slot's patch pixels
    in every SAI, and the SAI index [1, 1, 1, A] to go with them."""
    dev = bidx.device
    disp = torch.as_tensor(displacements(nd), dtype=torch.long, device=dev)
    off = disp[slot_doff(bidx, sim_y, sim_x, ref, center_index(nd),
                         doff).long()]  # [G, N, A, 2]
    pix = torch.arange(k * k, device=dev)[:, None]
    yy = (sim_y.long()[..., None] + off[..., 0])[:, :, None, :] + pix // k
    xx = (sim_x.long()[..., None] + off[..., 1])[:, :, None, :] + pix % k
    a_i = torch.arange(bidx.shape[0], device=dev)[None, None, None, :]
    return yy, xx, a_i


def extract_groups_plain(planes, bidx, sim_y, sim_x, mask, ref: int, *,
                         k: int, nd: int, doff=None) -> torch.Tensor:
    """Plain torch version of the extract kernel (same contract)."""
    yy, xx, a_i = patch_coords(bidx, sim_y, sim_x, ref, k, nd, doff)
    out = planes[:, a_i, yy, xx]  # [P, G, N, k*k, A]
    return torch.where(mask[None, :, :, None, None], out, 0.0).contiguous()


def check_geometry(planes, bidx, sim_y, sim_x, mask, k: int, nd: int,
                   doff=None):
    dev = planes.device
    require(bidx, "bidx", torch.int32, 3, dev)
    require(sim_y, "sim_y", torch.int32, 2, dev)
    require(sim_x, "sim_x", torch.int32, 2, dev)
    require(mask, "mask", torch.bool, 2, dev)
    _, a, hp, wp = planes.shape
    if bidx.shape != (a, hp - k + 1, wp - k + 1):
        raise ValueError(f"bidx {tuple(bidx.shape)} does not fit planes "
                         f"{tuple(planes.shape)} at k={k}")
    if sim_x.shape != sim_y.shape or mask.shape != sim_y.shape:
        raise ValueError("sim_y, sim_x and mask differ in shape")
    if not 1 <= k <= 16 or nd < 0:
        raise ValueError(f"two-kernel path takes 1 <= k <= 16, nd >= 0; got "
                         f"k={k}, nd={nd}")
    if doff is not None:
        require(doff, "doff", torch.int32, 3, dev)
        if doff.shape != (*sim_y.shape, a):
            raise ValueError(f"doff {tuple(doff.shape)} vs slots "
                             f"{tuple(sim_y.shape)} of {a} SAIs")


def extract_groups(planes, bidx, sim_y, sim_x, mask, ref: int, *, k: int,
                   nd: int, doff=None) -> torch.Tensor:
    """Group tensor [P, G, N, k*k, A] (contract in the module docstring).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if planes.device.type == "cpu":
        return extract_groups_plain(planes, bidx, sim_y, sim_x, mask, ref,
                                    k=k, nd=nd, doff=doff)
    require(planes, "planes", torch.float32, 4)
    check_geometry(planes, bidx, sim_y, sim_x, mask, k, nd, doff)
    p, a, hp, wp = planes.shape
    g, n = sim_y.shape
    out = torch.empty((p, g, n, k * k, a), dtype=planes.dtype,
                      device=planes.device)
    if g == 0:
        return out
    with torch.cuda.device(planes.device):
        rc = library().lfbm5d_extract_groups(
            planes.data_ptr(), bidx.data_ptr(),
            None if doff is None else doff.data_ptr(), sim_y.data_ptr(),
            sim_x.data_ptr(), mask.data_ptr(), out.data_ptr(), g * n, p, a,
            hp, wp, hp - k + 1, wp - k + 1, k, nd, ref, stream_of(planes),
        )
    check(rc, "extract_groups")
    extract_groups.launches += 1
    return out


extract_groups.launches = 0
