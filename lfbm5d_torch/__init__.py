"""lfbm5d_torch — the LFBM5D light-field denoiser in PyTorch, with its hot
loops as hand-written CUDA kernels for Hopper (sm_90a).

A port of `lfbm5d_tpu` (the JAX reference, which stays beside it). It keeps
its own copies of the reference's numpy-only modules (`config`, `lf.color`,
`lf.pad`, `lf.synth`, `lf.noise`, the native PNG codec) and imports neither
jax nor `lfbm5d_tpu`. The command line is `python -m lfbm5d_torch.cli`.
"""

from lfbm5d_torch.config import (  # noqa: F401
    DenoiseParams,
    PRESETS,
    SR_SCHEDULES,
    SRParams,
    StepParams,
    default_denoise_params,
    default_ht_params,
    default_wiener_params,
    preset_denoise_params,
)
from lfbm5d_torch.lf.io import load_lf, save_lf  # noqa: F401
from lfbm5d_torch.lf.metrics import (  # noqa: F401
    psnr,
    psnr_device,
    psnr_grid_device,
    rmse,
)
from lfbm5d_torch.models import LFDenoiser, LFSuperResolver  # noqa: F401
from lfbm5d_torch.parallel import make_devices  # noqa: F401
from lfbm5d_torch.pipeline.adaptive import (  # noqa: F401
    adaptive_denoise_params,
    denoise_region_adaptive,
    select_preset,
)
from lfbm5d_torch.pipeline.denoise import run_bm5d  # noqa: F401
from lfbm5d_torch.pipeline.sr import run_sr  # noqa: F401
from lfbm5d_torch.pipeline.streaming import denoise_batch  # noqa: F401

__version__ = "0.1.0"
