"""Quality metrics on [0, 255]-scale tensors, reduced on their device.

Counterparts of `lfbm5d_tpu.lf.metrics`: `rmse`, `psnr` (the plain RMSE
form, unclipped), `psnr_device` (clips pred to [0, peak] first; only the
scalar MSE leaves the device) and `psnr_grid_device` (clips; only aH*aW
scalars leave it). The reductions run in float64 on the first argument's
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _pair(pred, ref):
    pred = torch.as_tensor(pred)
    ref = torch.as_tensor(ref, device=pred.device, dtype=torch.float64)
    return pred.to(torch.float64), ref


def rmse(a, b) -> float:
    """Root-mean-square difference of a and b (tensors or arrays), reduced
    on a's device."""
    a, b = _pair(a, b)
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def psnr(a, b, peak: float = 255.0) -> float:
    """PSNR of a against b (tensors or arrays), 20 log10(peak / rmse), with
    no clipping; inf where they are equal."""
    r = rmse(a, b)
    if r == 0:
        return float("inf")
    return 20.0 * math.log10(peak / r)


def psnr_device(pred: torch.Tensor, ref, peak: float = 255.0) -> float:
    """PSNR of clip(pred, 0, peak) against ref (tensor or array), i.e.
    psnr(clip(pred, 0, peak), ref)."""
    p, r = _pair(pred, ref)
    d = p.clamp(0.0, peak) - r
    mse = float(torch.mean(d * d))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def psnr_grid_device(pred, ref, peak: float = 255.0) -> np.ndarray:
    """Per-SAI PSNR grid [aH, aW] of clip(pred, 0, peak) against ref, the
    reductions on pred's device; an SAI equal to ref reads inf."""
    p, r = _pair(pred, ref)
    d = p.clamp(0.0, peak) - r
    m = torch.mean(d * d, dim=(2, 3, 4)).cpu().numpy()
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(peak * peak / m)
