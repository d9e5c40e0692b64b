"""Light-field transfer helpers: a port of part of `lfbm5d_tpu/lf/io.py`.

Only `fetch_rounded` is ported so far; the directory-of-images loader and
writer (`load_lf`, `save_lf`) are ROADMAP.md A9.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch_rounded(lf, bit_depth: int = 8) -> np.ndarray:
    """A tensor LF as save-ready values, quantised on its device so the
    device->host copy moves uint8 (or 16-bit) values instead of float32.

    Clamped to [0, 255] and rounded half-up (the native io_png convention);
    16-bit values are round(v * 257) and come back divided by 257. Returns
    float32 on the host. Host arrays pass through unchanged."""
    if not torch.is_tensor(lf):
        return np.asarray(lf)
    v = lf.to(torch.float32).clamp(0.0, 255.0)
    if bit_depth == 16:
        # uint16 through int16 with an offset: torch copies int16 natively
        q = (torch.floor(v * 257.0 + 0.5) - 32768.0).to(torch.int16)
        q = q.cpu().numpy().astype(np.int32) + 32768
        return (q.astype(np.float64) / 257.0).astype(np.float32)
    q = torch.floor(v + 0.5).to(torch.uint8)
    return q.cpu().numpy().astype(np.float32)
