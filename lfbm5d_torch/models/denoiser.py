"""High-level denoiser API over the two-step pipeline: a port of
`lfbm5d_tpu/models/denoiser.py`. Construct once with parameters, then call
on any number of light fields."""

from __future__ import annotations

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams
from lfbm5d_torch.lf.metrics import psnr


class LFDenoiser:
    """Two-step (HT -> Wiener) LFBM5D light-field denoiser.

    Example:
        den = LFDenoiser(DenoiseParams(sigma=25.0))
        basic, final = den(noisy_lf)   # on the CUDA card

    device None runs on the input tensor's device, or on the CUDA card for
    an array (raises without one; pass device="cpu" to run on the host).
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

    def batch(self, lfs, mesh=None):
        """Batched and streaming denoising: not ported yet."""
        raise NotImplementedError(
            "LFDenoiser.batch: batched and streaming denoising are not "
            "ported yet (ROADMAP.md A8)")

    def evaluate(self, noisy_lf, clean_lf) -> dict:
        """Denoise and report PSNRs (of outputs clipped to [0, 255])
        against a clean reference."""
        basic, final = self(noisy_lf)
        noisy = torch.as_tensor(noisy_lf, dtype=final.dtype,
                                device=final.device)
        return {
            "psnr_noisy_db": psnr(noisy, clean_lf),
            "psnr_basic_db": psnr(basic, clean_lf),
            "psnr_final_db": psnr(final, clean_lf),
        }
