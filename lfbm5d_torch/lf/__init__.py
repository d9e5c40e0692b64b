from lfbm5d_tpu.lf.color import channel_sigma_scales, color_matrix  # noqa: F401
from lfbm5d_tpu.lf.noise import add_noise_np  # noqa: F401
from lfbm5d_tpu.lf.synth import synthetic_lf  # noqa: F401
from lfbm5d_torch.lf.metrics import psnr  # noqa: F401
from lfbm5d_torch.lf.pad import (  # noqa: F401
    ind_initialize,
    pad_lf,
    ref_sai_grid,
    symmetric_pad,
)
