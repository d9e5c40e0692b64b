"""Symmetric padding for tensors, by index, and the reference grids
(counterpart of lfbm5d_tpu.lf.pad; `ind_initialize` and `ref_sai_grid` are
copies of its numpy functions).

The reference pads every SAI edge-inclusively, as `np.pad(mode="symmetric")`
does. torch's `F.pad(mode="reflect")` is edge-EXCLUSIVE, so the port builds
the numpy index map once and gathers with it. The port's own callers name
the spatial axes; without them `symmetric_pad` guesses them from the
trailing axis' size, as the reference does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def ind_initialize(size: int, k: int, p: int) -> np.ndarray:
    """Reference-patch top-left coordinates along one axis of an unpadded
    SAI: every `p` pixels from 0, plus a final position flushed to the
    boundary (size - k) if the stepped grid does not land on it."""
    last = size - k
    if last < 0:
        raise ValueError(f"image extent {size} smaller than patch size {k}")
    ind = list(range(0, last + 1, p))
    if ind[-1] != last:
        ind.append(last)
    return np.asarray(ind, dtype=np.int32)


def ref_sai_grid(a_h: int, a_w: int, p_ang: int = 1) -> np.ndarray:
    """Flattened indices of the SAIs that serve as references: every SAI for
    p_ang == 1, else a strided angular grid with boundary flush
    (`ind_initialize` with k=1). Groups still span every SAI."""
    ss = ind_initialize(a_h, 1, p_ang)
    ts = ind_initialize(a_w, 1, p_ang)
    return (ss[:, None] * a_w + ts[None, :]).reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
def _sym_index(n: int, before: int, after: int,
               device: torch.device) -> torch.Tensor:
    # cached per device: a fresh host->device copy would drain the stream
    idx = np.pad(np.arange(n), (before, after), mode="symmetric")
    return torch.as_tensor(idx, device=device)


def symmetric_pad(x, pad, axes=None) -> torch.Tensor:
    """Pad each axis in `axes` of x (a tensor or array) by `pad` ((before,
    after) or an int for both) with edge-inclusive mirroring; equals
    np.pad(..., mode="symmetric"). axes None: the reference's rule, the two
    axes before a trailing channel axis of size <= 4 when x has 3 or more
    axes, else the last two."""
    x = torch.as_tensor(x)
    if axes is None:
        axes = (-3, -2) if x.ndim >= 3 and x.shape[-1] <= 4 else (-2, -1)
    before, after = (pad, pad) if isinstance(pad, int) else pad
    for ax in axes:
        x = x.index_select(ax, _sym_index(x.shape[ax], before, after,
                                          x.device))
    return x


def pad_lf(lf: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad every SAI of an [aH, aW, H, W, C] light field symmetrically."""
    return symmetric_pad(lf, pad, (2, 3))
