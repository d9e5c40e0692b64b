"""Light-field I/O: a port of `lfbm5d_tpu/lf/io.py`.

A light field on disk is a directory of per-SAI images named by a
printf-style pattern with two angular indices (e.g. ``SAI_%02d_%02d.png``),
an angular extent aH x aW and index offsets for datasets whose usable grid
is a central sub-grid. 8-bit and 16-bit images are read and written; pixels
are on the float [0, 255] scale in memory (16-bit values divided by 257).

The images are decoded and encoded on the host: by the thread-pooled
native libpng codec (`lfbm5d_torch.native`) where it builds, else by
OpenCV or PIL. These choose a host codec, not a device. `fetch_rounded`
quantises a tensor on its device before the copy to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _pattern_name(pattern: str, s: int, t: int) -> str:
    return pattern % (s, t)


def _paths(directory, pattern, a_h, a_w, s_offset, t_offset):
    return [os.path.join(directory,
                         _pattern_name(pattern, s + s_offset, t + t_offset))
            for s in range(a_h) for t in range(a_w)]


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


def load_lf(directory: str, pattern: str, a_h: int, a_w: int,
            s_offset: int = 0, t_offset: int = 0,
            use_native: str = "auto") -> np.ndarray:
    """Load an LF as a float array [aH, aW, H, W, C] in [0, 255] units
    (float32 from the native decoder, float64 from OpenCV or PIL).

    use_native: 'auto' uses the native PNG decoder where it builds, else
    OpenCV or PIL; 'never' forces OpenCV or PIL; 'always' raises where the
    native path is unavailable or the inputs are not PNG files.
    """
    if use_native not in ("auto", "never", "always"):
        raise ValueError(f"use_native must be auto, never or always, got "
                         f"{use_native!r}")
    paths = _paths(directory, pattern, a_h, a_w, s_offset, t_offset)
    if use_native != "never":
        if all(p.lower().endswith(".png") for p in paths):
            try:
                from lfbm5d_torch import native

                if native.available():
                    from PIL import Image

                    probe = np.asarray(Image.open(paths[0]))
                    h, w = probe.shape[:2]
                    c = 1 if probe.ndim == 2 else probe.shape[2]
                    return native.load_lf_native(paths, a_h, a_w, h, w,
                                                 min(c, 3))
                if use_native == "always":
                    raise RuntimeError(f"native PNG decoder unavailable: "
                                       f"{native.unavailable_reason()}")
            except Exception:
                if use_native == "always":
                    raise
        elif use_native == "always":
            raise RuntimeError("native loader handles PNG inputs only")

    def read_one(path):
        # PIL silently degrades 16-bit multi-channel PNGs; prefer OpenCV
        try:
            import cv2

            arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if arr is None:
                raise FileNotFoundError(path)
            if arr.ndim == 3:
                arr = arr[:, :, :3][:, :, ::-1]  # strip alpha, BGR -> RGB
        except ImportError:
            from PIL import Image

            arr = np.asarray(Image.open(path))
            if arr.ndim == 3 and arr.shape[2] > 3:
                arr = arr[:, :, :3]  # strip alpha, as cv2 and native do
        if arr.dtype == np.uint16:
            arr = arr.astype(np.float64) / 257.0
        else:
            arr = arr.astype(np.float64)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    sais = [read_one(p) for p in paths]
    return np.stack(sais).reshape(a_h, a_w, *sais[0].shape)


def save_lf(lf, directory: str, pattern: str, s_offset: int = 0,
            t_offset: int = 0, bit_depth: int = 8) -> None:
    """Write an [aH, aW, H, W, C] float LF (in [0, 255]; an array, or a
    tensor, which is copied to the host as it is) as per-SAI images.

    Uses the thread-pooled native libpng encoder where it builds, else PIL
    (OpenCV for 16-bit colour). The native writer rounds half-up (the
    io_png convention, as `fetch_rounded` does); the fallback uses np.round:
    they differ only on exact .5 sample values.
    """
    if torch.is_tensor(lf):
        lf = lf.detach().cpu().numpy()
    os.makedirs(directory, exist_ok=True)
    a_h, a_w = lf.shape[:2]
    paths = _paths(directory, pattern, a_h, a_w, s_offset, t_offset)
    if lf.ndim == 5 and lf.shape[-1] in (1, 3) and bit_depth in (8, 16):
        from lfbm5d_torch import native

        # an encoder that does not build falls back to PIL/OpenCV; an encode
        # error (IOError) propagates: a partial write is not retried with
        # another rounding convention
        if native.available():
            native.save_lf_native(np.asarray(lf), paths, bit_depth)
            return
    from PIL import Image

    for i, path in enumerate(paths):
        arr = np.asarray(lf[i // a_w, i % a_w], dtype=np.float64)
        if bit_depth == 16:
            out = np.clip(np.round(arr * 257.0), 0, 65535).astype(np.uint16)
        else:
            out = np.clip(np.round(arr), 0, 255).astype(np.uint8)
        if out.shape[-1] == 1:
            out = out[:, :, 0]
        if bit_depth == 16 and out.ndim == 3:
            # PIL has no 16-bit multi-channel PNG mode; use OpenCV (BGR)
            import cv2

            cv2.imwrite(path, out[:, :, ::-1])
        else:
            Image.fromarray(out).save(path)
