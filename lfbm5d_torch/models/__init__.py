from lfbm5d_torch.models.denoiser import LFDenoiser  # noqa: F401
from lfbm5d_torch.models.sr import LFSuperResolver  # noqa: F401
