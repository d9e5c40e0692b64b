"""Flat-region detection and the per-SAI 2D fallback filter.

Counterpart of `lfbm5d_tpu.ops.flat`, whose docstring holds the spec:
reference-grid positions whose angular-redundancy statistic
    D(y, x) = (1/A) * sum_v box_k((x_v - mean_v x_v)^2)(y, x) / k^2
(channel 0 of the NOISY LF in both steps, quantized like BM distances) is at
most flat_tau * sigma_c0^2 * (A-1)/A build no group; pixels no group covers
take the angular-mean k x k blockwise transform-domain estimate.

The shrinkage without a pilot is EMPIRICAL Wiener against the mean's own
spectrum, as the reference's code does (its docstring says HT; the code is
the spec).
"""

from __future__ import annotations

import math

import torch

from lfbm5d_torch.lf.pad import symmetric_pad
from lfbm5d_torch.ops.distances import DIST_QUANT, box_sum


def flat_ref_mask(planes: torch.Tensor, ys, xs, k: int, flat_tau: float,
                  sigma0: torch.Tensor) -> torch.Tensor:
    """True where the reference-grid position is angular-REDUNDANT.

    planes: [A, Hp, Wp] channel-0 NOISY image of every SAI (padded).
    ys/xs: reference grids (padded coords; arrays or tensors). sigma0:
    channel-0 sigma (0-d tensor). Returns bool [len(ys)*len(xs)].
    """
    ysi = torch.as_tensor(ys, dtype=torch.long, device=planes.device)
    xsi = torch.as_tensor(xs, dtype=torch.long, device=planes.device)
    a = planes.shape[0]
    m = planes.mean(dim=0)
    dv = ((planes - m[None]) ** 2).mean(dim=0)  # [Hp, Wp]
    d = box_sum(dv, k) / (k * k)
    qd = torch.round(d[ysi][:, xsi] * DIST_QUANT)
    thr_q = torch.round(
        flat_tau * sigma0 * sigma0 * ((a - 1) / a) * DIST_QUANT
    )
    return (qd <= thr_q).reshape(-1)


def _blockify(x: torch.Tensor, k: int):
    """[H, W, C] -> ([by, bx, k, k, C], H, W) with symmetric pad."""
    h, w, c = x.shape
    ph, pw = (-h) % k, (-w) % k
    if ph:
        x = symmetric_pad(x, (0, ph), (0,))
    if pw:
        x = symmetric_pad(x, (0, pw), (1,))
    hp, wp = x.shape[:2]
    b = x.reshape(hp // k, k, wp // k, k, c)
    return b.permute(0, 2, 1, 3, 4), h, w


def _t2(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    x = torch.einsum("uq,...qvc->...uvc", m, x)
    return torch.einsum("vq,...uqc->...uvc", m, x)


def fallback_shrink_2d(x: torch.Tensor, sigma_c: torch.Tensor,
                       f2: torch.Tensor, i2: torch.Tensor, lambda_3d: float,
                       pilot: torch.Tensor | None = None) -> torch.Tensor:
    """Angular-mean k x k blockwise transform shrinkage (the den==0 fallback).

    x: [aH, aW, H, W, C] noisy LF. sigma_c: [C]. f2/i2: the k x k tau_2d
    pair. pilot: basic-estimate LF -> Wiener against its angular mean;
    None -> empirical Wiener against the mean's own spectrum (lambda_3d is
    unused, as in the reference). Returns [aH, aW, H, W, C].
    """
    del lambda_3d
    k = f2.shape[0]
    a_h, a_w = x.shape[:2]
    sig_m = sigma_c / math.sqrt(a_h * a_w)
    xb, h, w = _blockify(x.mean(dim=(0, 1)), k)
    spec = _t2(f2, xb)
    s2 = sig_m * sig_m
    if pilot is None:
        b2 = torch.clamp(spec * spec - s2, min=0.0)
        filt = spec * (b2 / (b2 + s2))
    else:
        pb, _, _ = _blockify(pilot.mean(dim=(0, 1)), k)
        sb = _t2(f2, pb)
        b2 = sb * sb
        filt = spec * (b2 / (b2 + s2))
    est = _t2(i2, filt).permute(0, 2, 1, 3, 4)  # [by, k, bx, k, C]
    by, _, bx, _, c = est.shape
    est = est.reshape(by * k, bx * k, c)[:h, :w]
    return est.expand(a_h, a_w, h, w, c)
