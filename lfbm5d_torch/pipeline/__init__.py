from lfbm5d_torch.pipeline.denoise import (  # noqa: F401
    build_denoise_fn,
    ht_step,
    run_bm5d,
    wiener_step,
)
