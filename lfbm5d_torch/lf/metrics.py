"""Quality metrics on [0, 255]-scale tensors, reduced on their device.

Counterparts of `lfbm5d_tpu.lf.metrics`: `psnr` of `psnr_device` (only the
scalar MSE leaves the device; `psnr_device` is the same function under the
reference's name), `psnr_grid_device` (only aH*aW scalars do) and `rmse`.
The reductions run in float64.
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


def psnr(pred: torch.Tensor, ref, peak: float = 255.0) -> float:
    """PSNR of clip(pred, 0, peak) against ref (tensor or array)."""
    p, r = _pair(pred, ref)
    d = p.clamp(0.0, peak) - r
    mse = float(torch.mean(d * d))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


psnr_device = psnr


def psnr_grid_device(pred, ref, peak: float = 255.0) -> np.ndarray:
    """Per-SAI PSNR grid [aH, aW] of clip(pred, 0, peak) against ref, the
    reductions on pred's device; an SAI equal to ref reads inf."""
    p, r = _pair(pred, ref)
    d = p.clamp(0.0, peak) - r
    m = torch.mean(d * d, dim=(2, 3, 4)).cpu().numpy()
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(peak * peak / m)
