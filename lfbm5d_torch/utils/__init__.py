from lfbm5d_torch.utils.timing import StageTimer, device_fence  # noqa: F401
