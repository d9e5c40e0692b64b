"""Separable 5D group transform as batched einsums.

A 5D group is a tensor [B, N, aH, aW, k, k, C]: B groups per batch, N-deep
similarity stack, aH x aW angular grid (one patch per SAI), k x k spatial
patch, C channels. The forward transform is tau_2D on (k, k), tau_4D on
(aH, aW), tau_5D along N (SURVEY.md §2.10.6); every factor is a small matrix
from `lfbm5d_torch.transforms.matrices`.

The stack transform is selected PER GROUP by `lvl = log2(stack_size)`:
`stack_matrices` zero-pads each size's matrix to N x N, so gathering the
per-group matrix and batch-matmuling it handles variable group sizes with
static shapes. Counterpart of `lfbm5d_tpu.transforms.apply`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lfbm5d_tpu.config import StepParams
from lfbm5d_torch.transforms import matrices as tm


@dataclass(frozen=True)
class GroupTransforms:
    """Transform constants for one step's group geometry, as tensors."""

    f2: torch.Tensor
    i2: torch.Tensor
    f4s: torch.Tensor | None  # None when tau_4d == 'id'
    f4t: torch.Tensor | None
    i4s: torch.Tensor | None
    i4t: torch.Tensor | None
    stack_f: torch.Tensor  # [log2(N)+1, N, N]
    stack_i: torch.Tensor

    @staticmethod
    def build(params: StepParams, a_h: int, a_w: int,
              dtype=torch.float32, device="cpu") -> "GroupTransforms":
        f2, i2 = tm.transform_pair(params.tau_2d, params.k)
        if params.tau_4d == "id":
            f4s = f4t = i4s = i4t = None
        else:
            f4s, i4s = tm.transform_pair(params.tau_4d, a_h)
            f4t, i4t = tm.transform_pair(params.tau_4d, a_w)
        sf, si = tm.stack_matrices(params.tau_5d, params.n_sim)
        return _from_arrays(
            (f2, i2, f4s, f4t, i4s, i4t, sf, si), dtype, device
        )


_FIELDS = ("f2", "i2", "f4s", "f4t", "i4s", "i4t", "stack_f", "stack_i")


def _from_arrays(arrays, dtype, device) -> GroupTransforms:
    def t(x):
        if x is None:
            return None
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return GroupTransforms(*(t(x) for x in arrays))


def from_reference(gt, dtype=torch.float32, device="cpu") -> GroupTransforms:
    """The reference package's GroupTransforms (fields as numpy arrays or
    None, e.g. `np.asarray` of each jax field) as the port's tensors."""
    return _from_arrays(
        tuple(getattr(gt, f) for f in _FIELDS), dtype, device
    )


def forward_5d(g: torch.Tensor, lvl: torch.Tensor, t: GroupTransforms):
    """Forward separable 5D transform.

    g: [B, N, aH, aW, k, k, C]; lvl: [B] integer stack-size log2 per group.
    """
    g = torch.einsum("uq,bnstqvc->bnstuvc", t.f2, g)
    g = torch.einsum("vq,bnstuqc->bnstuvc", t.f2, g)
    if t.f4s is not None:
        g = torch.einsum("sq,bnqtuvc->bnstuvc", t.f4s, g)
        g = torch.einsum("tq,bnsquvc->bnstuvc", t.f4t, g)
    m = t.stack_f[lvl]  # [B, N, N]
    return torch.einsum("bnq,bqstuvc->bnstuvc", m, g)


def inverse_5d(g: torch.Tensor, lvl: torch.Tensor, t: GroupTransforms):
    """Inverse separable 5D transform (stack -> angular -> spatial)."""
    m = t.stack_i[lvl]
    g = torch.einsum("bnq,bqstuvc->bnstuvc", m, g)
    if t.i4s is not None:
        g = torch.einsum("sq,bnqtuvc->bnstuvc", t.i4s, g)
        g = torch.einsum("tq,bnsquvc->bnstuvc", t.i4t, g)
    g = torch.einsum("uq,bnstqvc->bnstuvc", t.i2, g)
    return torch.einsum("vq,bnstuqc->bnstuvc", t.i2, g)
