"""Color-space matrices: a copy of `lfbm5d_tpu/lf/color.py` (its
`color_matrix` and `channel_sigma_scales`).

The reference's `color_space_transform` (utilities.cpp, SURVEY.md §2 #5)
supports RGB<->OPP/YUV/YCbCr. The OPP matrix rows are unit-L2-normalized so
white Gaussian noise of std sigma in RGB stays std sigma in every OPP channel
(SURVEY.md §2.10.1). For the non-normalized spaces (yuv/ycbcr) the per-channel
noise std is sigma * ||row||_2; `channel_sigma_scales` exposes those factors so
block matching thresholds and shrinkage use the correct per-channel sigma.
"""

from __future__ import annotations

import numpy as np


def _unit_rows(m: np.ndarray) -> np.ndarray:
    return m / np.linalg.norm(m, axis=1, keepdims=True)


# OPP (opponent color space) with unit-L2 rows: Y ~ (R+G+B), U ~ (R-B),
# V ~ (R-2G+B). Exactly orthonormal rows -> noise std preserved per channel.
_OPP = _unit_rows(
    np.array(
        [
            [1.0, 1.0, 1.0],
            [1.0, 0.0, -1.0],
            [1.0, -2.0, 1.0],
        ],
        dtype=np.float64,
    )
)

# ITU-R BT.601 luma/chroma matrices (no offset; the DC offset of digital
# YCbCr is irrelevant to AWGN filtering and omitted, matching the IPOL
# convention of offset-free linear transforms).
_YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14713, -0.28886, 0.436],
        [0.615, -0.51499, -0.10001],
    ],
    dtype=np.float64,
)

_YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float64,
)


def color_matrix(space: str) -> np.ndarray:
    """Forward 3x3 matrix M: channels_out = M @ rgb. 'rgb' -> identity."""
    if space == "opp":
        return _OPP.copy()
    if space == "yuv":
        return _YUV.copy()
    if space == "ycbcr":
        return _YCBCR.copy()
    if space == "rgb":
        return np.eye(3, dtype=np.float64)
    raise ValueError(f"unknown color space {space!r}")


def channel_sigma_scales(space: str) -> np.ndarray:
    """Per-channel noise-std multipliers: sigma_c = sigma * scale[c]."""
    m = color_matrix(space)
    return np.linalg.norm(m, axis=1)

