"""High-level denoiser API over the two-step pipeline: a port of
`lfbm5d_tpu/models/denoiser.py`. Construct once with parameters, then call
on any number of light fields."""

from __future__ import annotations

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams
from lfbm5d_torch.lf.metrics import psnr_device


class LFDenoiser:
    """Two-step (HT -> Wiener) LFBM5D light-field denoiser.

    Example:
        den = LFDenoiser(DenoiseParams(sigma=25.0))
        basic, final = den(noisy_lf)   # on the CUDA card
        basics, finals = den.batch(lfs, devices=make_devices())

    device None runs on the input tensor's device, or on the CUDA card for
    an array (raises without one; pass device="cpu" to run on the host).
    engine: run_bm5d's ('auto', 'auto_bf16' for the bfloat16 transform
    chain, or 'torch').
    """

    def __init__(self, params: DenoiseParams | None = None,
                 engine: str = "auto", dtype: str = "float32", device=None):
        self.params = params or DenoiseParams()
        self.engine = engine
        self.dtype = dtype
        self.device = device

    def __call__(self, noisy_lf):
        from lfbm5d_torch.pipeline.denoise import run_bm5d

        return run_bm5d(noisy_lf, self.params, dtype=self.dtype,
                        engine=self.engine, device=self.device)

    def denoise(self, noisy_lf) -> np.ndarray:
        """Returns only the final estimate as a numpy array."""
        _, final = self(noisy_lf)
        return final.cpu().numpy()

    def batch(self, lfs, devices=None):
        """Denoise [B, aH, aW, H, W, C]: LF i on devices[i % len(devices)]
        (`parallel.make_devices`; None: this denoiser's device, else the
        batch tensor's, else the CUDA card). Returns (basic, final) batches
        on devices[0]."""
        from lfbm5d_torch.pipeline.streaming import denoise_batch

        if devices is None and self.device is not None:
            devices = [self.device]
        return denoise_batch(lfs, self.params, devices=devices,
                             dtype=self.dtype, engine=self.engine)

    def evaluate(self, noisy_lf, clean_lf) -> dict:
        """Denoise and report PSNRs (of outputs clipped to [0, 255])
        against a clean reference."""
        basic, final = self(noisy_lf)
        noisy = torch.as_tensor(noisy_lf, dtype=final.dtype,
                                device=final.device)
        return {
            "psnr_noisy_db": psnr_device(noisy, clean_lf),
            "psnr_basic_db": psnr_device(basic, clean_lf),
            "psnr_final_db": psnr_device(final, clean_lf),
        }
