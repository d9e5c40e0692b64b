"""High-level super-resolution API (reference SR branch, ICIP18): a port of
`lfbm5d_tpu/models/sr.py`."""

from __future__ import annotations

import numpy as np

from lfbm5d_torch.config import SRParams


class LFSuperResolver:
    """LFBM5D-SR: bicubic init + [5D-sparse-prior filter, back-projection].

    device None runs on the input tensor's device, or on the CUDA card for
    an array (raises without one; pass device="cpu" to run on the host).
    """

    def __init__(self, params: SRParams | None = None,
                 engine: str = "auto", dtype: str = "float32", device=None):
        self.params = params or SRParams()
        self.engine = engine
        self.dtype = dtype
        self.device = device

    def __call__(self, lr_lf, on_iteration=None):
        from lfbm5d_torch.pipeline.sr import run_sr

        return run_sr(lr_lf, self.params, on_iteration=on_iteration,
                      dtype=self.dtype, engine=self.engine,
                      device=self.device)

    def upscale(self, lr_lf) -> np.ndarray:
        return self(lr_lf).cpu().numpy()
