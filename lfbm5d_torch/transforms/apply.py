"""5D group transform as batched einsums (separable; the chain's angular
pass dense).

A 5D group is a tensor [B, N, aH, aW, k, k, C]: B groups per batch, N-deep
similarity stack, aH x aW angular grid (one patch per SAI), k x k spatial
patch, C channels. The forward transform is tau_2D on (k, k), tau_4D on
(aH, aW), tau_5D along N (SURVEY.md §2.10.6); every factor is a small matrix
from `lfbm5d_torch.transforms.matrices`.

The stack transform is selected PER GROUP by `lvl = log2(stack_size)`:
`stack_matrices` zero-pads each size's matrix to N x N, so gathering the
per-group matrix and batch-matmuling it handles variable group sizes with
static shapes. Counterpart of `lfbm5d_tpu.transforms.apply`.

The chain dtype (`chain`, None or torch.bfloat16) is the counterpart of the
reference kernel engine's `group_dtype` (its `pallas_bf16` engine,
lfbm5d_tpu/kernels/fused.py): the group is rounded to the chain dtype on
entry, and each of the three contractions (spatial, angular, stack) of
either direction is computed in the group's dtype on chain-valued operands
and its result rounded to the chain dtype (`chain_round`), as bf16 x bf16
products accumulated in f32 and stored in bf16 are. The reference rounds
dense tables: kron(F2, F2) and kron(F4s, F4t) cast to bf16. Here:

  * angular: the same dense table, round(kron(F4s, F4t)) [A, A] (f4, i4),
    applied as one contraction over the SAI axis. Rounding the 1-D factors
    instead would keep the pass separable but doubles the chain's gain on
    the mean, which is what costs the chain PSNR: at 9x9 the DCT's DC
    entry 1/3 rounds 0.195% high, so the product of the two rounded
    factors is 0.39% high, where the dense entry 1/9 is 0.195% high; a
    forward and inverse round trip scales the mean by 1.0078 against the
    reference's 1.0039.
  * spatial: the rounded 1-D factors round(F2) (f2, i2), applied
    separably as the group kernels do in registers; their products differ
    from the rounded dense entries by about 2**-9 relative (the 8-point
    DC entry 1/8 is exact in bf16, the product of its rounded factors
    1/sqrt(8) is 0.02% low).

The stack tables are rounded only for tau_5d = 'dct', which the reference
applies as a bf16 matrix; its Haar and Hadamard stacks are f32 butterflies,
rounded once at their end, so their tables stay unrounded here. The CUDA
group kernels (csrc/group_stage.cuh, BF16) round at the same points.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from lfbm5d_torch.config import StepParams
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
    chain: torch.dtype | None = None  # None: the group's own dtype
    f4: torch.Tensor | None = None  # chain only: dense angular [A, A]
    i4: torch.Tensor | None = None

    @staticmethod
    def build(params: StepParams, a_h: int, a_w: int,
              dtype=torch.float32, device="cpu",
              chain: torch.dtype | None = None) -> "GroupTransforms":
        f2, i2 = tm.transform_pair(params.tau_2d, params.k)
        f4 = i4 = None
        if params.tau_4d == "id":
            f4s = f4t = i4s = i4t = None
        else:
            f4s, i4s = tm.transform_pair(params.tau_4d, a_h)
            f4t, i4t = tm.transform_pair(params.tau_4d, a_w)
            if chain is not None:  # one dense angular table (docstring)
                f4 = round_table(np.kron(f4s, f4t), chain)
                i4 = round_table(np.kron(i4s, i4t), chain)
                f4s = f4t = i4s = i4t = None
        sf, si = chain_stack_matrices(params, chain)
        r = functools.partial(round_table, chain=chain)
        return _from_arrays(
            (r(f2), r(i2), f4s, f4t, i4s, i4t, sf, si), dtype, device,
            chain, f4, i4,
        )


_FIELDS = ("f2", "i2", "f4s", "f4t", "i4s", "i4t", "stack_f", "stack_i")


def chain_round(x: torch.Tensor, chain: torch.dtype | None) -> torch.Tensor:
    """x rounded to the chain dtype (round to nearest even), kept in x's
    dtype; x itself when chain is None."""
    return x if chain is None else x.to(chain).to(x.dtype)


def round_table(m, chain: torch.dtype | None):
    """A float64 table rounded to the chain dtype (through float32, as a
    float32 table is cast), as float64; None and chain None pass through."""
    if m is None or chain is None:
        return m
    t = torch.as_tensor(np.asarray(m), dtype=torch.float32)
    return chain_round(t, chain).double().numpy()


def chain_stack_matrices(params: StepParams, chain: torch.dtype | None):
    """The stack tables of the chain: rounded for tau_5d = 'dct' (a matrix
    in the reference's bf16 chain), unrounded for its f32 butterflies."""
    sf, si = tm.stack_matrices(params.tau_5d, params.n_sim)
    if params.tau_5d in ("haar", "hadamard"):
        return sf, si
    return round_table(sf, chain), round_table(si, chain)


def _from_arrays(arrays, dtype, device, chain=None, f4=None,
                 i4=None) -> GroupTransforms:
    def t(x):
        if x is None:
            return None
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return GroupTransforms(*(t(x) for x in arrays), chain=chain, f4=t(f4),
                           i4=t(i4))


def _angular(g: torch.Tensor, ms, mt, m):
    """The angular contraction of g [B, N, aH, aW, k, k, C]: separable by
    ms, mt, or dense by m [A, A] over the flattened SAI axis; g itself
    when all are None."""
    if m is not None:
        b, n, a_h, a_w = g.shape[:4]
        g = torch.einsum("qa,bnauvc->bnquvc", m,
                         g.reshape(b, n, a_h * a_w, *g.shape[4:]))
        return g.reshape(b, n, a_h, a_w, *g.shape[3:])
    if ms is None:
        return g
    g = torch.einsum("sq,bnqtuvc->bnstuvc", ms, g)
    return torch.einsum("tq,bnsquvc->bnstuvc", mt, g)


def from_reference(gt, dtype=torch.float32, device="cpu") -> GroupTransforms:
    """The reference package's GroupTransforms (fields as numpy arrays or
    None, e.g. `np.asarray` of each jax field) as the port's tensors."""
    return _from_arrays(
        tuple(getattr(gt, f) for f in _FIELDS), dtype, device
    )


def forward_5d(g: torch.Tensor, lvl: torch.Tensor, t: GroupTransforms):
    """Forward separable 5D transform.

    g: [B, N, aH, aW, k, k, C]; lvl: [B] integer stack-size log2 per group.
    With a chain dtype the group and each contraction's result are rounded
    to it (module docstring).
    """
    r = functools.partial(chain_round, chain=t.chain)
    g = torch.einsum("uq,bnstqvc->bnstuvc", t.f2, r(g))
    g = r(torch.einsum("vq,bnstuqc->bnstuvc", t.f2, g))
    g = r(_angular(g, t.f4s, t.f4t, t.f4))
    m = t.stack_f[lvl]  # [B, N, N]
    return r(torch.einsum("bnq,bqstuvc->bnstuvc", m, g))


def inverse_5d(g: torch.Tensor, lvl: torch.Tensor, t: GroupTransforms):
    """Inverse separable 5D transform (stack -> angular -> spatial), with
    the chain's rounding points as forward_5d."""
    r = functools.partial(chain_round, chain=t.chain)
    m = t.stack_i[lvl]
    g = r(torch.einsum("bnq,bqstuvc->bnstuvc", m, g))
    g = r(_angular(g, t.i4s, t.i4t, t.i4))
    g = torch.einsum("uq,bnstqvc->bnstuvc", t.i2, g)
    return r(torch.einsum("vq,bnstuqc->bnstuvc", t.i2, g))
