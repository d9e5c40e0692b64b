"""Coefficient shrinkage and aggregation weights (SURVEY.md §2.10.7-8).

Counterpart of `lfbm5d_tpu.ops.shrinkage`. Operates on 5D spectra
[B, N, aH, aW, k, k, C]. Padded stack slots (beyond a group's power-of-two
size) carry exactly-zero coefficients (zero rows of the padded stack
matrix), so they never pass the hard threshold and add nothing to the Wiener
energy.

With a chain dtype (transforms/apply.py) the spectra hold chain-rounded
values; the shrinkage and weights are computed in the spectra's own dtype
(f32 for the bf16 chain), and only the filtered spectrum is rounded to the
chain again (a no-op for HT, whose kept coefficients are already rounded).
"""

from __future__ import annotations

import torch

from lfbm5d_torch.transforms.apply import (
    GroupTransforms,
    chain_round,
    forward_5d,
    inverse_5d,
)

_GROUP_AXES = (1, 2, 3, 4, 5)


def ht_shrink(spec: torch.Tensor, sigma_c: torch.Tensor, lambda_3d: float):
    """Hard threshold at lambda * sigma_c per channel.

    Returns (filtered spectrum, weight [B, C]) with weight
    1/(sigma_c^2 * N_nz), or 1.0 for an all-zero group.
    """
    keep = spec.abs() >= lambda_3d * sigma_c
    filt = spec * keep
    nnz = keep.sum(dim=_GROUP_AXES).to(spec.dtype)  # [B, C]
    w = torch.where(nnz > 0, 1.0 / (sigma_c**2 * nnz.clamp(min=1.0)), 1.0)
    return filt, w


def wiener_shrink(spec_noisy: torch.Tensor, spec_basic: torch.Tensor,
                  sigma_c: torch.Tensor, chain: torch.dtype | None = None):
    """Empirical Wiener filter w = B^2/(B^2 + sigma_c^2) from the basic
    spectrum, applied to the noisy spectrum (rounded to the chain dtype).

    Returns (filtered spectrum, weight [B, C]) with weight
    1/(sigma_c^2 * sum(w^2)), or 1.0 when the filter is identically zero.
    """
    b2 = spec_basic**2
    wien = b2 / (b2 + sigma_c**2)
    filt = chain_round(spec_noisy * wien, chain)
    wsum = (wien**2).sum(dim=_GROUP_AXES)
    w = torch.where(
        wsum > 0, 1.0 / (sigma_c**2 * wsum.clamp(min=1e-30)), 1.0
    )
    return filt, w


def sd_weight(est: torch.Tensor, lvl: torch.Tensor, a: int, k: int):
    """SD-based aggregation weight (use_sd): 1/var over the live group values.

    est: filtered-and-inverted group [B, N, aH, aW, k, k, C]; invalid stack
    slots are exactly zero and excluded via the live-value count.
    """
    cnt = ((1 << lvl.long()) * a * k * k).to(est.dtype)[:, None]  # [B, 1]
    s1 = est.sum(dim=_GROUP_AXES)
    s2 = (est**2).sum(dim=_GROUP_AXES)
    mean = s1 / cnt
    var = s2 / cnt - mean**2
    return torch.where(var > 0, 1.0 / var.clamp(min=1e-30), 1.0)


def filter_groups(g: torch.Tensor, gb: torch.Tensor | None, lvl: torch.Tensor,
                  gt: GroupTransforms, sigma_c: torch.Tensor,
                  lambda_3d: float, use_sd: bool):
    """Forward 5D transform -> HT (gb None) or Wiener guided by the basic
    groups gb -> inverse. g, gb: [B, N, aH, aW, k, k, C].

    Returns (estimate [B, N, aH, aW, k, k, C], aggregation weight [B, C]).
    """
    spec = forward_5d(g, lvl, gt)
    if gb is None:
        filt, wgt = ht_shrink(spec, sigma_c, lambda_3d)
    else:
        filt, wgt = wiener_shrink(spec, forward_5d(gb, lvl, gt), sigma_c,
                                  gt.chain)
    est = inverse_5d(filt, lvl, gt)
    if use_sd:
        wgt = sd_weight(est, lvl, g.shape[2] * g.shape[3], g.shape[4])
    return est, wgt
