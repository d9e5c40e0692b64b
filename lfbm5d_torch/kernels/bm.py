"""Block-matching kernels (csrc/bm.cu) and their plain versions.

`self_distances_kernel` replaces lfbm5d_tpu/kernels/bm.py::
self_distances_kernel and `cross_argmin_all_kernel` replaces
lfbm5d_tpu/kernels/bm.py::cross_argmin_all_kernel. The plain versions are
`lfbm5d_torch.ops.distances.{self_distances, cross_argmin_all}`; both
kernels add in the same order in exact fp32, so they agree with them bit for
bit (csrc/bm.cu header). A wrapper runs the plain version for a CPU tensor
and the kernel for a CUDA tensor; it raises on anything the kernel does not
take (float64, non-contiguous, wrong rank). `launches` counts kernel
launches. `bm_plan` is the cross-argmin kernel's launch plan, a copy of
csrc/bm.cu::make_cross_plan (tests/test_torch_bm_tiling.py emulates the
tiling it describes; chip_smoke.py (a) holds it to the library's).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lfbm5d_torch.kernels._build import check, library, require, stream_of
from lfbm5d_torch.ops.distances import (
    DIST_QUANT,
    cross_argmin_all,
    self_distances,
)


NUM_SMS = 132  # H100 SXM: the plan's wave size
CROSS_BLOCKS_PER_SM = 3  # resident cross-argmin blocks per SM
TILE_Y = 32  # output rows of a cross-argmin tile
TILE_VC = 64  # vertical-sum columns of a tile; output columns TILE_VC-k+1
STRIP_ROWS = 8  # rows of a thread's vertical strip
SEG_COLS = 8  # columns of a thread's horizontal segment
MAX_K = 16
MAX_ND = 8
SELF_R = 8  # adjacent dx per self-BM thread
SELF_MAX_THREADS = 256
SELF_MIN_THREADS = 64
SELF_THREADS_PER_SM = 1024  # resident self-BM threads the plan aims at
MAX_STATIC_SMEM = 48 * 1024  # the self-BM kernel's window budget


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sv_pitch(k: int) -> int:
    """Row pitch (floats) of the vertical sums: room for the last segment's
    float4 loads, a multiple of 4 with an odd number of float4s."""
    need = (TILE_VC - SEG_COLS) + 4 * _cdiv(SEG_COLS + k - 1, 4)
    return need if (need // 4) % 2 else need + 4


def bm_plan(hp: int, wp: int, a: int, k: int,
            nd: int) -> tuple[int, int, int, int, int]:
    """(tile rows, tile columns, SAI chunk, grid, dynamic shared bytes) of
    the cross-argmin kernel: a copy of csrc/bm.cu::make_cross_plan. A block
    owns one TILE_Y x (TILE_VC-k+1) output tile and a chunk of the A SAIs;
    the chunk minimises waves * (2 chunk + 1) among those whose grid fills
    two waves of CROSS_BLOCKS_PER_SM blocks on NUM_SMS SMs (any chunk when
    none does), ties to the larger chunk. Shared memory: two vertical-sum
    buffers [TILE_Y][sv_pitch] and two SAI tiles with their halo,
    TILE_Y+k-1+2nd rows at a fixed pitch of TILE_VC+2*MAX_ND floats."""
    v0, v1 = hp - k + 1, wp - k + 1
    tx = TILE_VC - k + 1
    tiles = _cdiv(v0, TILE_Y) * _cdiv(v1, tx)
    slots = NUM_SMS * CROSS_BLOCKS_PER_SM
    best = None  # (not fills, cost), chunk, grid
    for chunk in range(a, 0, -1):
        nch = _cdiv(a, chunk)
        if _cdiv(a, nch) != chunk:
            continue
        grid = tiles * nch
        key = (grid < 2 * slots, _cdiv(grid, slots) * (2 * chunk + 1))
        if best is None or key < best[0]:
            best = (key, chunk, grid)
    sh = TILE_Y + k - 1 + 2 * nd
    smem = 4 * (2 * TILE_Y * sv_pitch(k) + 2 * sh * (TILE_VC + 2 * MAX_ND))
    return TILE_Y, tx, best[1], best[2], smem


def self_plan(k: int, n: int, t: int) -> tuple[int, int, int]:
    """(threads, window pitch, runs per dy) of the self-BM kernel at t
    reference patches: a copy of csrc/bm.cu::make_self_plan.
    Each thread takes runs of SELF_R adjacent dx at one dy; the nsel * nruns
    items go in rounds, each but the last full, as few as keep
    SELF_THREADS_PER_SM threads on every SM (between SELF_MAX_THREADS and
    SELF_MIN_THREADS a block); the window rows have room for the last,
    ragged run."""
    nsel = 2 * n + 1
    nruns = _cdiv(nsel, SELF_R)
    items = nsel * nruns
    lo = _cdiv(items, SELF_MAX_THREADS)
    hi = max(lo, _cdiv(items, SELF_MIN_THREADS))
    rounds = min(max(t * items // (NUM_SMS * SELF_THREADS_PER_SM), lo), hi)
    threads = 32 * _cdiv(_cdiv(items, rounds), 32)
    return threads, (nruns * SELF_R + k - 1) | 1, nruns


@lru_cache(maxsize=None)
def _grid_on(raw: bytes,
             device: torch.device) -> tuple[torch.Tensor, int, int]:
    """(int32 coordinates on the device, min, max) of a grid given by its
    int32 bytes: one host-to-device copy per grid, not per launch."""
    g = np.frombuffer(raw, dtype=np.int32)
    return torch.tensor(g, device=device), int(g.min()), int(g.max())


def self_distances_kernel(plane: torch.Tensor, ys, xs, k: int,
                          n: int) -> torch.Tensor:
    """[T, (2n+1)^2] int32 quantized self-similarity distances of `plane`
    ([Hp, Wp] f32) at the grid ys x xs (host sequences, padded coords)."""
    if plane.device.type == "cpu":
        return self_distances(plane, ys, xs, k, n)
    require(plane, "plane", torch.float32, 2)
    hp, wp = plane.shape
    ys_d, y_lo, y_hi = _grid_on(np.asarray(ys, np.int32).tobytes(),
                                plane.device)
    xs_d, x_lo, x_hi = _grid_on(np.asarray(xs, np.int32).tobytes(),
                                plane.device)
    if min(y_lo, x_lo) < 0 or y_hi + k > hp or x_hi + k > wp:
        raise ValueError("reference grid outside the plane")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"self-BM kernel takes k <= {MAX_K}; got k={k}")
    if 4 * (k + 2 * n) * self_plan(k, n, 1)[1] > MAX_STATIC_SMEM:
        raise ValueError(f"search window too large: k={k}, n={n}")
    nsel = 2 * n + 1
    out = torch.empty((len(ys_d) * len(xs_d), nsel * nsel),
                      dtype=torch.int32, device=plane.device)
    with torch.cuda.device(plane.device):
        rc = library().lfbm5d_self_distances(
            plane.data_ptr(), ys_d.data_ptr(), xs_d.data_ptr(),
            out.data_ptr(), hp, wp, len(ys_d), len(xs_d), k, n,
            DIST_QUANT / (k * k), stream_of(plane),
        )
    check(rc, "self_distances_kernel")
    self_distances_kernel.launches += 1
    return out


self_distances_kernel.launches = 0


def cross_argmin_all_kernel(ref_plane: torch.Tensor, planes: torch.Tensor,
                            k: int, nd: int) -> torch.Tensor:
    """[A, Hp-k+1, Wp-k+1] int32 first-occurrence disparity argmin maps of
    `ref_plane` ([Hp, Wp] f32) against every plane of `planes` ([A, Hp, Wp]
    f32)."""
    if ref_plane.device.type == "cpu":
        return cross_argmin_all(ref_plane, planes, k, nd)
    require(ref_plane, "ref_plane", torch.float32, 2)
    require(planes, "planes", torch.float32, 3, ref_plane.device)
    a, hp, wp = planes.shape
    if ref_plane.shape != (hp, wp):
        raise ValueError(f"ref_plane {tuple(ref_plane.shape)} vs planes "
                         f"{tuple(planes.shape)}")
    if not 1 <= k <= min(MAX_K, hp, wp) or not 0 <= nd <= MAX_ND or a < 1:
        raise ValueError(f"cross-argmin kernel takes k <= {MAX_K} within the "
                         f"plane, nd <= {MAX_ND}, A >= 1; got k={k}, nd={nd}, "
                         f"planes {tuple(planes.shape)}")
    out = torch.empty((a, hp - k + 1, wp - k + 1), dtype=torch.int32,
                      device=planes.device)
    with torch.cuda.device(planes.device):
        rc = library().lfbm5d_cross_argmin(
            ref_plane.data_ptr(), planes.data_ptr(), out.data_ptr(), a, hp,
            wp, k, nd, DIST_QUANT / (k * k), stream_of(planes),
        )
    check(rc, "cross_argmin_all_kernel")
    cross_argmin_all_kernel.launches += 1
    return out


cross_argmin_all_kernel.launches = 0
