"""Dense block-matching distance maps (hot loops A and B of SURVEY.md §3.1).

Counterpart of `lfbm5d_tpu.ops.distances`, and the plain twin of the CUDA
kernels in `lfbm5d_torch.kernels.bm`. For each displacement d of the search
window, the squared-difference image (I - shift(I, d))^2 is box-filtered with
the k x k patch window; shifted reads outside the plane are zero.

Spec points that decide parity (ops/distances.py docstring of the reference):

* every distance is k^2-normalized and quantized to integers of
  1/DIST_QUANT, rounded half to even (`torch.round`);
* candidate/displacement order is row-major (dy outer, dx inner) and the
  argmin keeps the first occurrence (strict <);
* box sums are k-tap shifted adds in the plane's dtype, vertical taps first,
  each sum sequential. No cumsum or integral image: f32 totals reach ~1e10
  in [0,255]^2 units, where the ulp exceeds the quantum. No cuDNN
  convolution either (TF32 by default on the card). The CUDA kernels add in
  the same order, so in f32 they agree with these twins bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DIST_QUANT = 8.0  # quantization: distances are integers of 1/DIST_QUANT units


def displacements(n: int) -> np.ndarray:
    """Row-major displacement list [(2n+1)^2, 2] of (dy, dx) in [-n, n]."""
    r = np.arange(-n, n + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=1).astype(np.int32)


def center_index(n: int) -> int:
    """Flat index of displacement (0, 0) in `displacements(n)`."""
    return n * (2 * n + 1) + n


def _quantize(box: torch.Tensor, k: int) -> torch.Tensor:
    return torch.round(box * (DIST_QUANT / (k * k))).to(torch.int32)


def box_sum(e: torch.Tensor, k: int) -> torch.Tensor:
    """Sliding k x k window sum over the last two axes, VALID:
    [..., H, W] -> [..., H-k+1, W-k+1]; vertical taps first, sequential."""
    v0, v1 = e.shape[-2] - k + 1, e.shape[-1] - k + 1
    s = e[..., 0:v0, :]
    for i in range(1, k):
        s = s + e[..., i:i + v0, :]
    out = s[..., 0:v1]
    for j in range(1, k):
        out = out + s[..., j:j + v1]
    return out


def self_distances(plane: torch.Tensor, ys, xs, k: int, n: int):
    """Self-similarity SSDs at reference-grid positions.

    plane: [Hp, Wp] channel-0 SAI (padded). ys/xs: top-left coordinate grids
    (padded coords; arrays or tensors). Returns [len(ys)*len(xs), (2n+1)^2]
    int32 quantized distances, candidate axis in row-major window order.
    """
    hp, wp = plane.shape
    nsel = 2 * n + 1
    ysi = torch.as_tensor(ys, dtype=torch.long, device=plane.device)
    xsi = torch.as_tensor(xs, dtype=torch.long, device=plane.device)
    ext = F.pad(plane, (n, n, n, n))
    rows = []
    for dyi in range(nsel):
        band = ext[dyi:dyi + hp]  # [Hp, Wp + 2n]: rows shifted by dy
        sh = band.unfold(1, wp, 1).permute(1, 0, 2)  # [nsel(dx), Hp, Wp]
        d = plane - sh
        e = d * d
        # vertical taps at the sampled rows, then horizontal at sampled cols
        vs = e[:, ysi]
        for i in range(1, k):
            vs = vs + e[:, ysi + i]
        box = vs[:, :, xsi]
        for j in range(1, k):
            box = box + vs[:, :, xsi + j]
        rows.append(_quantize(box, k))  # [nsel(dx), Ty, Tx]
    q = torch.stack(rows)  # [dy, dx, Ty, Tx]
    return q.reshape(nsel * nsel, -1).T.contiguous()


def self_distances_batch(planes: torch.Tensor, ys, xs, k: int, n: int):
    """`self_distances` of every plane of planes [S, Hp, Wp]:
    [S, len(ys)*len(xs), (2n+1)^2] int32."""
    return torch.stack([self_distances(p, ys, xs, k, n) for p in planes])


def self_distances_batched(plane: torch.Tensor, ys, xs, k: int, n: int):
    """The reference's displacement-batched form of `self_distances` (same
    results); `self_distances` here already batches a row of displacements
    per pass."""
    return self_distances(plane, ys, xs, k, n)


def cross_argmin_all(ref_plane: torch.Tensor, planes: torch.Tensor, k: int,
                     nd: int):
    """First-occurrence disparity argmin maps of one reference plane against
    every plane.

    For every patch position q of `ref_plane`, the row-major-first-occurrence
    argmin over displacements d in [-nd, nd]^2 of
    SSD(ref patch at q, plane patch at q + d). planes: [A, Hp, Wp].
    Returns [A, Hp-k+1, Wp-k+1] int32 flat displacement indices.
    """
    a, hp, wp = planes.shape
    v0, v1 = hp - k + 1, wp - k + 1
    ext = F.pad(planes, (nd, nd, nd, nd))
    best = torch.full((a, v0, v1), np.iinfo(np.int32).max, dtype=torch.int32,
                      device=planes.device)
    bidx = torch.zeros((a, v0, v1), dtype=torch.int32, device=planes.device)
    for m, (dy, dx) in enumerate(displacements(nd)):
        sh = ext[:, nd + dy:nd + dy + hp, nd + dx:nd + dx + wp]
        d = ref_plane - sh
        q = _quantize(box_sum(d * d, k), k)
        better = q < best
        best = torch.where(better, q, best)
        bidx = torch.where(better, torch.full_like(bidx, m), bidx)
    return bidx


def cross_argmin(ref_plane: torch.Tensor, other_plane: torch.Tensor, k: int,
                 nd: int):
    """`cross_argmin_all` against one plane: [Hp-k+1, Wp-k+1] int32."""
    return cross_argmin_all(ref_plane, other_plane[None], k, nd)[0]
