"""Hand-written CUDA kernels (csrc/) with their plain versions."""

from lfbm5d_torch.kernels.accumulate import accumulate_groups  # noqa: F401
from lfbm5d_torch.kernels.extract import extract_groups  # noqa: F401
