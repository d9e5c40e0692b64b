"""Per-slot sampling of the disparity argmin maps (plain version).

Replaces `lfbm5d_tpu/kernels/gather.py::sample_doff` (TPU kernel, per-tile
band DMA of the argmin table + per-slot row reads). On the card there is no
standalone kernel for it: the group kernel (`csrc/fused.cu`) reads
`bidx[a, sim_y, sim_x]` itself in its prologue, so the [T, N, A] table is
never written to device memory. This plain version is what the dense step
and the group kernel's plain twin use.
"""

from __future__ import annotations

import torch


def sample_doff(bidx: torch.Tensor, sim_y: torch.Tensor, sim_x: torch.Tensor,
                ref: int, c_ang: int) -> torch.Tensor:
    """bidx: [A, V0, V1] argmin maps of one reference; sim_y/sim_x: [T, N]
    similar-patch positions. Returns [T, N, A] displacement indices; the
    reference SAI's own lane is the centered displacement c_ang (its angular
    match is the similar patch itself)."""
    ang = bidx[:, sim_y, sim_x]  # [A, T, N]
    ang[ref] = c_ang
    return ang.permute(1, 2, 0)
