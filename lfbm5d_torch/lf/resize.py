"""Resampling operators of the SR pipeline: a port of
`lfbm5d_tpu/lf/resize.py`.

  * `upsample`: per-SAI bicubic as `jax.image.resize(method="cubic")` has
    it: Keys' cubic with a = -0.5, sample positions (i + 0.5)/scale - 0.5,
    the weights of each output sample renormalised to sum 1 (which is what
    happens at the borders instead of clamping). It is applied as two dense
    per-axis [scale*H, H] resize matrices, built in float64 on the host and
    cached per (size, scale, dtype, device). `F.interpolate(mode="bicubic")`
    is not the same function: it uses a = -0.75 and clamps the border.
  * `downsample`: exact alpha x alpha box average, with an optional
    Gaussian pre-blur (`blur_sigma`: the anti-aliased decimation model).
  * `gaussian_blur`: separable per-SAI Gaussian with reflect borders, taps
    normalised to sum 1 in float64.

All take and return [aH, aW, H, W, C] tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(size: int, scale: int) -> np.ndarray:
    """[scale*size, size] float64 cubic resize matrix of one axis (upsampling,
    so no antialias stretch of the kernel)."""
    out_size = size * scale
    inv = 1.0 / float(scale)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(sample[None, :]
                           - np.arange(size, dtype=np.float64)[:, None]))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return np.where(inside[None, :], w, 0.0).T


@lru_cache(maxsize=None)
def _resize_on(size: int, scale: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return torch.as_tensor(resize_matrix(size, scale), dtype=dtype,
                           device=device)


def upsample(lf: torch.Tensor, scale: int) -> torch.Tensor:
    """[aH, aW, H, W, C] -> [aH, aW, scale*H, scale*W, C], per-SAI cubic."""
    _, _, h, w, _ = lf.shape
    if scale == 1:
        return lf
    my = _resize_on(h, scale, lf.dtype, lf.device)
    mx = _resize_on(w, scale, lf.dtype, lf.device)
    return torch.einsum("Yh,abhwc,Xw->abYXc", my, lf, mx)


def gaussian_blur(lf: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable per-SAI Gaussian blur with reflect borders; kernel radius
    ceil(3*sigma), taps normalised to sum 1 in float64."""
    if sigma <= 0:
        return lf
    r = int(np.ceil(3.0 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / sigma) ** 2)
    taps /= taps.sum()
    t = torch.as_tensor(taps, dtype=lf.dtype, device=lf.device)

    def conv_axis(arr, axis):
        n = arr.shape[axis]
        # numpy's reflect index map (any radius), as jnp.pad(mode="reflect")
        idx = torch.as_tensor(np.pad(np.arange(n), r, mode="reflect"),
                              device=arr.device)
        ext = arr.index_select(axis, idx)
        out = 0.0
        for i in range(2 * r + 1):
            out = out + t[i] * ext.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(lf, 2), 3)


def downsample(lf: torch.Tensor, scale: int,
               blur_sigma: float = 0.0) -> torch.Tensor:
    """Box-average decimation: [aH, aW, H, W, C] -> [..., H/s, W/s, C];
    blur_sigma > 0 applies a Gaussian pre-blur first."""
    a_h, a_w, h, w, c = lf.shape
    if h % scale or w % scale:
        raise ValueError(f"extent {(h, w)} not divisible by scale {scale}")
    lf = gaussian_blur(lf, blur_sigma)
    x = lf.reshape(a_h, a_w, h // scale, scale, w // scale, scale, c)
    return x.mean(dim=(3, 5))
