"""lfbm5d_torch — the LFBM5D light-field denoiser in PyTorch, with its hot
loops as hand-written CUDA kernels for Hopper (sm_90a).

A port of `lfbm5d_tpu` (the JAX reference, which stays beside it). It reuses
the reference's numpy-only modules (`lfbm5d_tpu.config`, `lf.color`,
`lf.pad`, `lf.synth`, `lf.noise`) and never imports jax.
"""

from lfbm5d_tpu.config import (  # noqa: F401
    DenoiseParams,
    PRESETS,
    StepParams,
    preset_denoise_params,
)
from lfbm5d_torch.lf.metrics import psnr  # noqa: F401
from lfbm5d_torch.pipeline.denoise import run_bm5d  # noqa: F401

__version__ = "0.1.0"
