"""Separable 5D transforms on the flat group layout of the two-kernel path.

Counterpart of `lfbm5d_tpu.transforms.flat`. Group tensor: [B, N, k*k, A]
— B groups (one plane each), N-deep similarity stack, k*k spatial pixels
row-major, A = aH*aW SAIs last (the reference pads this axis to 128 lanes;
here it is exactly A). Each separable factor is one dense product:

  * spatial tau_2D:  kron(F2, F2)   [k*k, k*k]
  * angular tau_4D:  kron(F4s, F4t) [A, A] (s-major, as the SAI index a =
    s*aW + t)
  * stack tau_5D:    per-group power-of-two matrices [N, N], batched by lvl.

These are plain matrix products outside any kernel (XLA matmuls in the
reference), so they run as torch.matmul. They run in full fp32 only while
TF32 is off for matmuls (`torch.backends.cuda.matmul.allow_tf32`, False by
default): TF32 keeps about three decimal digits, which moves HT decisions.

With a chain dtype (`chain`, transforms/apply.py) each product is still an
f32 matmul, on chain-valued operands, and its result is rounded to the
chain: the same rounding points and tables as the group kernels' chain.
The angular table is the rounded dense kron, as the reference's; the
spatial one is the kron of the rounded 1-D factors (exact in f32: a product
of two bf16 values has at most 16 significant bits), so the flat chain
computes what the group kernels do up to f32 summation order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from lfbm5d_torch.config import StepParams
from lfbm5d_torch.transforms import matrices as tm
from lfbm5d_torch.transforms.apply import (
    chain_round,
    chain_stack_matrices,
    round_table,
)


@dataclass(frozen=True)
class FlatTransforms:
    k2f: torch.Tensor  # [k*k, k*k]
    k2i: torch.Tensor
    k4f: torch.Tensor  # [A, A]
    k4i: torch.Tensor
    stack_f: torch.Tensor  # [log2(N)+1, N, N]
    stack_i: torch.Tensor
    chain: torch.dtype | None = None  # None: the group's own dtype

    @staticmethod
    def build(params: StepParams, a_h: int, a_w: int, dtype=torch.float32,
              device="cpu", chain: torch.dtype | None = None
              ) -> "FlatTransforms":
        def r(m):
            return round_table(m, chain)

        f2, i2 = map(r, tm.transform_pair(params.tau_2d, params.k))
        if params.tau_4d == "id":
            f4 = i4 = np.eye(a_h * a_w)
        else:
            f4s, i4s = tm.transform_pair(params.tau_4d, a_h)
            f4t, i4t = tm.transform_pair(params.tau_4d, a_w)
            f4, i4 = r(np.kron(f4s, f4t)), r(np.kron(i4s, i4t))
        sf, si = chain_stack_matrices(params, chain)

        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        return FlatTransforms(t(np.kron(f2, f2)), t(np.kron(i2, i2)), t(f4),
                              t(i4), t(sf), t(si), chain)


def _stack(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-group stack product: m [B, N, N] over g [B, N, P, A]."""
    return torch.bmm(m, g.reshape(g.shape[0], g.shape[1], -1)).view(g.shape)


def forward_flat(g: torch.Tensor, lvl: torch.Tensor,
                 t: FlatTransforms) -> torch.Tensor:
    """g: [B, N, k*k, A]; lvl: [B] integer stack-size log2. The 5D
    spectrum, same layout (each product rounded to the chain dtype)."""
    r = functools.partial(chain_round, chain=t.chain)
    g = r(torch.matmul(t.k2f, r(g)))
    g = r(torch.matmul(g, t.k4f.T))
    return r(_stack(t.stack_f[lvl], g))


def inverse_flat(g: torch.Tensor, lvl: torch.Tensor,
                 t: FlatTransforms) -> torch.Tensor:
    """Inverse of forward_flat: stack, angular, spatial."""
    r = functools.partial(chain_round, chain=t.chain)
    g = r(_stack(t.stack_i[lvl], g))
    g = r(torch.matmul(g, t.k4i.T))
    return r(torch.matmul(t.k2i, g))
