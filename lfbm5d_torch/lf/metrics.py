"""Quality metrics on [0, 255]-scale tensors, reduced on their device.

Counterpart of `lfbm5d_tpu.lf.metrics.psnr_device`: only the scalar MSE
leaves the device. The reduction runs in float64.
"""

from __future__ import annotations

import math

import torch


def psnr(pred: torch.Tensor, ref, peak: float = 255.0) -> float:
    """PSNR of clip(pred, 0, peak) against ref (tensor or array)."""
    ref = torch.as_tensor(ref, device=pred.device, dtype=torch.float64)
    d = pred.to(torch.float64).clamp(0.0, peak) - ref
    mse = float(torch.mean(d * d))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)
