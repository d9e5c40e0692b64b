from lfbm5d_torch.parallel.devices import make_devices  # noqa: F401
