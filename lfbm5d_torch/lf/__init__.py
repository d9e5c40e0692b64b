from lfbm5d_torch.lf.color import (  # noqa: F401
    channel_sigma_scales,
    color_matrix,
    rgb_to_space,
    space_to_rgb,
)
from lfbm5d_torch.lf.io import fetch_rounded, load_lf, save_lf  # noqa: F401
from lfbm5d_torch.lf.metrics import (  # noqa: F401
    psnr,
    psnr_device,
    psnr_grid_device,
    rmse,
)
from lfbm5d_torch.lf.noise import add_noise, add_noise_np  # noqa: F401
from lfbm5d_torch.lf.pad import (  # noqa: F401
    ind_initialize,
    pad_lf,
    ref_sai_grid,
    symmetric_pad,
)
from lfbm5d_torch.lf.synth import synthetic_lf, synthetic_lf_multi  # noqa: F401
