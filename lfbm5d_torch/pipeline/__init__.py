from lfbm5d_torch.pipeline.denoise import (  # noqa: F401
    build_denoise_fn,
    ht_step,
    run_bm5d,
    wiener_step,
)
from lfbm5d_torch.pipeline.sr import run_sr, sigma_schedule  # noqa: F401
from lfbm5d_torch.pipeline.adaptive import (  # noqa: F401
    adaptive_denoise_params,
    content_stats,
    probe_maps,
    denoise_region_adaptive,
    select_preset,
)
from lfbm5d_torch.pipeline.driver import stream_directories  # noqa: F401
from lfbm5d_torch.pipeline.stream_io import (  # noqa: F401
    StreamReport,
    stream_denoise_dirs,
)
from lfbm5d_torch.pipeline.streaming import denoise_batch  # noqa: F401
