"""Symmetric padding for tensors, by index (counterpart of lfbm5d_tpu.lf.pad).

The reference pads every SAI edge-inclusively, as `np.pad(mode="symmetric")`
does. torch's `F.pad(mode="reflect")` is edge-EXCLUSIVE, so the port builds
the numpy index map once and gathers with it; the spatial axes are named
explicitly instead of being guessed from the trailing axis' size.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lfbm5d_tpu.lf.pad import ind_initialize, ref_sai_grid  # noqa: F401


@lru_cache(maxsize=None)
def _sym_index(n: int, before: int, after: int,
               device: torch.device) -> torch.Tensor:
    # cached per device: a fresh host->device copy would drain the stream
    idx = np.pad(np.arange(n), (before, after), mode="symmetric")
    return torch.as_tensor(idx, device=device)


def symmetric_pad(x: torch.Tensor, pad, axes) -> torch.Tensor:
    """Pad each axis in `axes` by `pad` ((before, after) or an int for both)
    with edge-inclusive mirroring; equals np.pad(..., mode="symmetric")."""
    before, after = (pad, pad) if isinstance(pad, int) else pad
    for ax in axes:
        x = x.index_select(ax, _sym_index(x.shape[ax], before, after,
                                          x.device))
    return x


def pad_lf(lf: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad every SAI of an [aH, aW, H, W, C] light field symmetrically."""
    return symmetric_pad(lf, pad, (2, 3))
