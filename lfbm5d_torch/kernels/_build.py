"""Build and load the CUDA kernels (lfbm5d_torch/csrc/*.cu) at first use.

nvcc compiles every source (one process per `.cu`, all started together)
and links them into one shared library with a plain C interface for sm_90a,
loaded with ctypes: pointers and the stream as c_void_p, ints as c_int. The
library lands in `build/kernels/<hash>/` at the repository root, keyed by a
hash of the sources, headers and flags, so a checkout builds once and reuses
it. Every C entry point returns cudaGetLastError(); `check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "lfbm5d_self_distances": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lfbm5d_cross_argmin": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "lfbm5d_bm_plan": [_I] * 5 + [_P],
    "lfbm5d_self_plan": [_I] * 3 + [_P],
    "lfbm5d_group_smem_bytes": [_I, _I, _I, _I],
    "lfbm5d_group_occupancy": [_I] * 5 + [_P],
    "lfbm5d_group_occupancy_banked": [_I] * 5 + [_P],
    "lfbm5d_group_step": [_P] * 13 + [_I] * 14 + [_F, _P],
    "lfbm5d_group_step_banked": [_P] * 13 + [_I] * 14 + [_F, _P],
    "lfbm5d_twokernel_plan": [_I, _I, _P],
    "lfbm5d_extract_groups": [_P] * 7 + [_I] * 10 + [_P],
    "lfbm5d_accumulate_groups": [_P] * 10 + [_I] * 10 + [_P],
    "lfbm5d_gather_plan": [_I, _I, _P],
    "lfbm5d_gather_rows": [_P] * 3 + [_I] * 2 + [_P],
}

_lib = None
build_seconds = None  # wall time of this process' nvcc run (None: cached)
source_seconds = {}  # nvcc seconds per source of this process' build
build_log = ""  # ptxas' report (registers, spills) of this process' build


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from lfbm5d_torch/csrc "
        "at first use and need the CUDA toolkit (CUDA_HOME)"
    )


def build(src_dir: Path = SRC_DIR) -> Path:
    """Compile the sources of src_dir if this hash has no library yet; its
    path."""
    global build_seconds, build_log, source_seconds
    srcs = sorted(src_dir.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(src_dir.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "liblfbm5d_kernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]

    def compile_one(cmd):
        t = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        return res, time.perf_counter() - t

    with ThreadPoolExecutor(len(cmds)) as pool:  # every nvcc at once
        results = list(pool.map(compile_one, cmds))
    failed, log = [], []
    source_seconds = {}
    for src, cmd, (res, sec) in zip(srcs, cmds, results):
        log.append(res.stderr)
        source_seconds[src.name] = sec
        if res.returncode:
            failed.append(f"nvcc failed ({res.returncode}): "
                          f"{' '.join(cmd)}\n{res.stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_name(f"{out.name}.{tag}")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = "".join(log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.lfbm5d_error_string.argtypes = [ctypes.c_int]
        lib.lfbm5d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc:
        msg = library().lfbm5d_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
