"""ctypes binding for the native parallel PNG codec (io_accel.cpp): a port
of `lfbm5d_tpu/native/__init__.py`.

The library is built at first use with g++ and libpng into
`build/native/<hash>/` at the repository root (the hash covers the source
and the flags, so a checkout builds once), the way `kernels/_build.py`
builds the CUDA kernels. Where g++ or libpng is missing, `available()` is
False and `lf.io` uses PIL or OpenCV: the native codec is an option of the
host's image I/O, never a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "io_accel.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-lpthread")

_lib = None
_failed = None  # why the build or load failed (None: not tried or built)


def build() -> Path:
    """Compile io_accel.cpp if this hash has no library yet; its path.
    Raises RuntimeError when g++ is missing or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PNG codec is built "
                           "from lfbm5d_torch/native/io_accel.cpp")
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libio_accel.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _ensure_built() -> bool:
    global _lib, _failed
    if _lib is not None:
        return True
    if _failed is not None:
        return False
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        _failed = str(e)
        return False
    fptr = ctypes.POINTER(ctypes.c_float)
    paths = ctypes.POINTER(ctypes.c_char_p)
    i, ip = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.lf_load_png.restype = ctypes.c_int
    lib.lf_load_png.argtypes = [paths, i, fptr, i, i, i, ip]
    lib.lf_save_png.restype = ctypes.c_int
    lib.lf_save_png.argtypes = [paths, i, fptr, i, i, i, i, ip]
    _lib = lib
    return True


def available() -> bool:
    """True when the codec is built (or builds now) and loads."""
    return _ensure_built()


def unavailable_reason() -> str | None:
    """Why available() is False (None when it is True or untried)."""
    return _failed


def load_lf_native(paths, a_h: int, a_w: int, h: int, w: int,
                   c: int) -> np.ndarray:
    """Decode `paths` (aH*aW PNG files) into [aH, aW, H, W, C] float32.

    All images must share (h, w) and decode to `c` channels; 16-bit samples
    are scaled to the [0, 255] float range (divided by 257), matching
    lfbm5d_torch.lf.io.load_lf."""
    if not _ensure_built():
        raise RuntimeError(f"native io_accel unavailable: {_failed}")
    n = len(paths)
    if n != a_h * a_w:
        raise ValueError(f"expected {a_h * a_w} paths, got {n}")
    out = np.empty((n, h, w, c), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    err_i = ctypes.c_int(-1)
    rc = _lib.lf_load_png(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, c, ctypes.byref(err_i),
    )
    if rc:
        bad = paths[err_i.value] if 0 <= err_i.value < n else "?"
        raise IOError(f"native PNG decode failed (code {rc}) for {bad!r}")
    return out.reshape(a_h, a_w, h, w, c)


def save_lf_native(lf, paths, bit_depth: int = 8) -> None:
    """Encode an [aH, aW, H, W, C] float LF to PNG files, thread-pooled;
    rounds half-up (8-bit) or scales by 257 and rounds half-up (16-bit)."""
    if not _ensure_built():
        raise RuntimeError(f"native io_accel unavailable: {_failed}")
    a_h, a_w, h, w, c = lf.shape
    n = a_h * a_w
    if len(paths) != n:
        raise ValueError(f"expected {n} paths, got {len(paths)}")
    data = np.ascontiguousarray(lf, dtype=np.float32).reshape(n, h, w, c)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    err_i = ctypes.c_int(-1)
    rc = _lib.lf_save_png(
        arr, n, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, c, bit_depth, ctypes.byref(err_i),
    )
    if rc:
        bad = paths[err_i.value] if 0 <= err_i.value < n else "?"
        raise IOError(f"native PNG encode failed (code {rc}) for {bad!r}")
