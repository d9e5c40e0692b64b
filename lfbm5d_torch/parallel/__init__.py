from lfbm5d_torch.parallel.devices import make_devices  # noqa: F401
from lfbm5d_torch.pipeline.streaming import denoise_batch  # noqa: F401
