"""Block-matching kernels (csrc/bm.cu) and their plain versions.

`self_distances_kernel` replaces lfbm5d_tpu/kernels/bm.py::
self_distances_kernel and `cross_argmin_all_kernel` replaces
lfbm5d_tpu/kernels/bm.py::cross_argmin_all_kernel. The plain versions are
`lfbm5d_torch.ops.distances.{self_distances, cross_argmin_all}`; both
kernels add in the same order in exact fp32, so they agree with them bit for
bit (csrc/bm.cu header). A wrapper runs the plain version for a CPU tensor
and the kernel for a CUDA tensor; it raises on anything the kernel does not
take (float64, non-contiguous, wrong rank). `launches` counts kernel
launches.
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


@lru_cache(maxsize=None)
def _grid_on(coords: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(coords, dtype=torch.int32, device=device)


def self_distances_kernel(plane: torch.Tensor, ys, xs, k: int,
                          n: int) -> torch.Tensor:
    """[T, (2n+1)^2] int32 quantized self-similarity distances of `plane`
    ([Hp, Wp] f32) at the grid ys x xs (host sequences, padded coords)."""
    if plane.device.type == "cpu":
        return self_distances(plane, ys, xs, k, n)
    require(plane, "plane", torch.float32, 2)
    hp, wp = plane.shape
    ys = tuple(int(v) for v in np.asarray(ys))
    xs = tuple(int(v) for v in np.asarray(xs))
    if min(ys + xs) < 0 or max(ys) + k > hp or max(xs) + k > wp:
        raise ValueError("reference grid outside the plane")
    if (k + 2 * n) ** 2 + k * k > 12 * 1024:
        raise ValueError(f"search window too large: k={k}, n={n}")
    nsel = 2 * n + 1
    out = torch.empty((len(ys) * len(xs), nsel * nsel), dtype=torch.int32,
                      device=plane.device)
    rc = library().lfbm5d_self_distances(
        plane.data_ptr(), _grid_on(ys, plane.device).data_ptr(),
        _grid_on(xs, plane.device).data_ptr(), out.data_ptr(), hp, wp,
        len(ys), len(xs), k, n, DIST_QUANT / (k * k), stream_of(plane),
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
    if not 1 <= k <= 16 or not 0 <= nd <= 8:
        raise ValueError(f"cross-argmin kernel takes k <= 16, nd <= 8; got "
                         f"k={k}, nd={nd}")
    out = torch.empty((a, hp - k + 1, wp - k + 1), dtype=torch.int32,
                      device=planes.device)
    rc = library().lfbm5d_cross_argmin(
        ref_plane.data_ptr(), planes.data_ptr(), out.data_ptr(), a, hp, wp, k,
        nd, DIST_QUANT / (k * k), stream_of(planes),
    )
    check(rc, "cross_argmin_all_kernel")
    cross_argmin_all_kernel.launches += 1
    return out


cross_argmin_all_kernel.launches = 0
