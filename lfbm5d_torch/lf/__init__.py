from lfbm5d_torch.lf.color import channel_sigma_scales, color_matrix  # noqa: F401
from lfbm5d_torch.lf.metrics import psnr  # noqa: F401
from lfbm5d_torch.lf.noise import add_noise_np  # noqa: F401
from lfbm5d_torch.lf.pad import (  # noqa: F401
    ind_initialize,
    pad_lf,
    ref_sai_grid,
    symmetric_pad,
)
from lfbm5d_torch.lf.synth import synthetic_lf, synthetic_lf_multi  # noqa: F401
