"""LFBM5D super-resolution (reference SR branch, ICIP18): a port of
`lfbm5d_tpu/pipeline/sr.py`.

Pipeline: per-SAI bicubic x-scale init, then n_iter rounds of
  (a) LFBM5D filtering of the HR estimate with a decreasing sigma schedule
      (the 5D sparse-coding prior), through `run_bm5d` with a sigma_c
      override, so every iteration takes the kernel step's routes, and
  (b) iterative back-projection: HR += gain * up(LR - down(HR)),
with the box-average decimation / bicubic upsampling model of
`lfbm5d_torch.lf.resize`. The sigma schedule is linear from sigma_init to
sigma_final. `on_iteration(i, hr)` is called after every iteration with the
HR tensor, so a driver can persist it.
"""

from __future__ import annotations

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams, SRParams
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.lf.resize import downsample, upsample
from lfbm5d_torch.pipeline.denoise import _dtype, _sigma_channels, run_bm5d


def sigma_schedule(params: SRParams) -> np.ndarray:
    return np.linspace(params.sigma_init, params.sigma_final, params.n_iter)


def run_sr(lr_lf, params: SRParams, on_iteration=None, dtype: str = "float32",
           engine: str = "auto", device=None) -> torch.Tensor:
    """Super-resolve an LR light field [aH, aW, h, w, C] by params.scale.

    Returns the HR estimate [aH, aW, scale*h, scale*w, C] on `device` (None:
    the input tensor's device, or the CUDA card for an array; raises without
    one unless device='cpu'). engine: run_bm5d's ('auto', 'auto_bf16' or
    'torch'), for every iteration's denoise."""
    lr = torch.as_tensor(lr_lf, dtype=_dtype(dtype),
                         device=resolve_device(device, lr_lf))
    hr = upsample(lr, params.scale)
    c = hr.shape[-1]
    # sigma enters only through sigma_c: params.sigma stays 0.0, so one
    # built pipeline serves the whole schedule
    dn = DenoiseParams(
        sigma=0.0,
        lambda_3d=params.lambda_3d,
        color_space=params.color_space,
        ht=params.ht,
        wiener=params.wiener,
        chunk=params.chunk,
    )
    for i, sigma in enumerate(sigma_schedule(params)):
        sigma_c = _sigma_channels(float(sigma), params.color_space, c, dtype,
                                  hr.device)
        _, hr = run_bm5d(hr, dn, dtype, engine, sigma_c=sigma_c)
        residual = lr - downsample(hr, params.scale, params.decimation_blur)
        hr = hr + params.bp_gain * upsample(residual, params.scale)
        if on_iteration is not None:
            on_iteration(i, hr)
    return hr
