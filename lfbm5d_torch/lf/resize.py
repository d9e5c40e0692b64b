"""Resampling operators of the SR pipeline: a port of
`lfbm5d_tpu/lf/resize.py`.

  * `upsample`: per-SAI resampling as `jax.image.resize` has it, for each
    of its methods (bicubic by default): the method's kernel (Keys' cubic
    with a = -0.5, the triangle, Lanczos of radius 3 or 5) at sample
    positions (i + 0.5)/scale - 0.5, the weights of each output sample
    renormalised to sum 1 (which is what happens at the borders instead of
    clamping). It is applied as two dense per-axis [scale*H, H] resize
    matrices, built in float64 on the host and cached per (size, scale,
    method, dtype, device); `nearest` gathers rows by JAX's own index rule.
    `F.interpolate` is not the same function for any method: its bicubic
    uses a = -0.75 and clamps the border.
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


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos(radius: float):
    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3,
                       y / np.where(x != 0, np.pi**2 * x**2, 1.0), 1.0)
        return np.where(x > radius, 0.0, out)
    return kernel


# jax.image.ResizeMethod's names and aliases -> the method
_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
            "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5"}
_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _method(name: str) -> str:
    """The method a jax.image.resize name or alias stands for; ValueError
    for any other name."""
    if name not in _METHODS:
        raise ValueError(f'Unknown resize method "{name}"')
    return _METHODS[name]


def nearest_index(size: int, scale: int) -> np.ndarray:
    """[scale*size] source rows of nearest upsampling: floor((i + 0.5) *
    size / (scale*size)), computed in float32 as jax.image.resize does."""
    n = size * scale
    pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(size)
    return np.floor(pos / np.float32(n)).astype(np.int64)


def resize_matrix(size: int, scale: int, method: str = "cubic") -> np.ndarray:
    """[scale*size, size] float64 resize matrix of one axis (upsampling, so
    no antialias stretch of the kernel) of a kernel method: linear, cubic,
    lanczos3 or lanczos5 (nearest gathers: `nearest_index`)."""
    out_size = size * scale
    inv = 1.0 / float(scale)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    dist = np.abs(sample[None, :] - np.arange(size, dtype=np.float64)[:, None])
    w = _KERNELS[_method(method)](dist)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return np.where(inside[None, :], w, 0.0).T


@lru_cache(maxsize=None)
def _resize_on(size: int, scale: int, method: str, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if method == "nearest":
        return torch.as_tensor(nearest_index(size, scale), device=device)
    return torch.as_tensor(resize_matrix(size, scale, method), dtype=dtype,
                           device=device)


def upsample(lf: torch.Tensor, scale: int,
             method: str = "cubic") -> torch.Tensor:
    """[aH, aW, H, W, C] -> [aH, aW, scale*H, scale*W, C], per SAI, by any
    method (or alias) of jax.image.resize; ValueError for another name."""
    method = _method(method)
    _, _, h, w, _ = lf.shape
    if scale == 1:
        return lf
    my = _resize_on(h, scale, method, lf.dtype, lf.device)
    mx = _resize_on(w, scale, method, lf.dtype, lf.device)
    if method == "nearest":
        return lf.index_select(2, my).index_select(3, mx)
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
