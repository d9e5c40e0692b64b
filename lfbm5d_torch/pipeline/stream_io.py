"""Disk-to-disk light-field streaming: a port of
`lfbm5d_tpu/pipeline/stream_io.py`.

The host's PNG decoding and encoding overlap the device's work:

    decode(i+1)  ||  denoise(i) on the card  ||  encode(i-1)

with a decode-ahead thread pool and an encoder pool. Decode and encode use
the thread-pooled native libpng codec where it builds (lf/io.py); results
are quantised on the device (`fetch_rounded`), so the copy to the host
moves uint8 (or 16-bit) values, not float32.

Failure isolation: each LF's device call is retried `retries` times; an LF
that still fails is recorded in the report and skipped (or written as the
identity estimate), never sinking the stream.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from lfbm5d_torch.config import DenoiseParams
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.lf.io import fetch_rounded, load_lf, save_lf
from lfbm5d_torch.pipeline.denoise import (
    _dtype,
    _sigma_channels,
    build_denoise_fn,
)


@dataclass
class StreamReport:
    """Per-stream accounting returned by stream_denoise_dirs."""

    n_done: int = 0
    n_failed: int = 0
    failures: list = field(default_factory=list)  # {job, attempts, error}
    seconds_total: float = 0.0
    seconds_device: float = 0.0  # device-blocked time in the main thread
    lf_seconds: list = field(default_factory=list)  # end-to-end per LF


def _default_run(fn, lf_dev, sigma_c):
    """The per-LF device call: the final estimate of fn (build_denoise_fn)."""
    return fn(lf_dev, sigma_c)[1]


def stream_denoise_dirs(jobs, params: DenoiseParams, a_h: int, a_w: int,
                        pattern: str = "SAI_%02d_%02d.png",
                        out_pattern: str | None = None, s_offset: int = 0,
                        t_offset: int = 0, bit_depth: int = 8,
                        dtype: str = "float32", engine: str = "auto",
                        retries: int = 1, on_fail: str = "skip",
                        lookahead: int = 2, device=None,
                        _run=None) -> StreamReport:
    """Stream (input_dir, output_dir) jobs through the denoiser.

    jobs: iterable of (input_dir, output_dir) pairs; every LF shares the
    (a_h, a_w, pattern) layout, and each spatial shape and channel count
    gets its pipeline (and its per-channel sigmas) once. `lookahead` LFs
    are decoded ahead of the device; encodes run behind it. on_fail: 'skip'
    leaves no output for a failed LF; 'identity' writes the noisy input;
    'raise' aborts the stream. device: where the LFs are denoised (None:
    the CUDA card; raises without one unless device='cpu'). engine:
    run_bm5d's ('auto', 'auto_bf16' or 'torch'). `_run` overrides the
    per-LF device call (tests inject faults through it).

    Returns a StreamReport (counts, failures, wall and device seconds).
    """
    if on_fail not in ("skip", "identity", "raise"):
        raise ValueError(f"on_fail must be skip, identity or raise, got "
                         f"{on_fail!r}")
    jobs = list(jobs)
    run = _run or _default_run
    dev = resolve_device(device)
    report = StreamReport()
    t_start = time.perf_counter()
    if not jobs:
        return report

    # shape -> (pipeline, per-channel sigmas): both follow the shape, so a
    # stream that mixes channel counts gives each LF its own sigmas
    fn_cache: dict[tuple, tuple] = {}

    def decode(job):
        return load_lf(job[0], pattern, a_h, a_w, s_offset=s_offset,
                       t_offset=t_offset)

    def encode(job, arr_q):
        save_lf(arr_q, job[1], out_pattern or pattern, s_offset=s_offset,
                t_offset=t_offset, bit_depth=bit_depth)

    with ThreadPoolExecutor(max_workers=max(1, lookahead)) as dec_pool, \
            ThreadPoolExecutor(max_workers=2) as enc_pool:
        dec_futs = [dec_pool.submit(decode, j) for j in jobs[:lookahead + 1]]
        enc_futs = []
        for i, job in enumerate(jobs):
            t_lf = time.perf_counter()
            lf = dec_futs[i].result()
            if i + lookahead + 1 < len(jobs):
                dec_futs.append(dec_pool.submit(decode,
                                                jobs[i + lookahead + 1]))
            key = lf.shape
            if key not in fn_cache:
                h, w, c = lf.shape[2:]
                fn_cache[key] = (
                    build_denoise_fn(params, a_h, a_w, h, w, c, dtype,
                                     engine, str(dev)),
                    _sigma_channels(params.sigma, params.color_space, c,
                                    dtype, dev))
            fn, sigma_c = fn_cache[key]

            lf_dev = torch.as_tensor(lf, dtype=_dtype(dtype), device=dev)
            t_dev = time.perf_counter()
            err, out_q = None, None
            for _ in range(retries + 1):
                try:
                    final = run(fn, lf_dev, sigma_c)
                    # quantised on the device: the host gets uint8 values
                    out_q = fetch_rounded(final, bit_depth=bit_depth)
                    err = None
                    break
                except Exception as e:
                    err = e
            report.seconds_device += time.perf_counter() - t_dev
            if err is not None:
                if on_fail == "raise":
                    raise err
                report.n_failed += 1
                report.failures.append({"job": job, "attempts": retries + 1,
                                        "error": repr(err)})
                if on_fail == "skip":
                    report.lf_seconds.append(time.perf_counter() - t_lf)
                    continue
                out_q = fetch_rounded(lf_dev, bit_depth=bit_depth)
            enc_futs.append(enc_pool.submit(encode, job, out_q))
            report.n_done += 1
            report.lf_seconds.append(time.perf_counter() - t_lf)
        for f in enc_futs:
            f.result()  # surface encoder errors
    report.seconds_total = time.perf_counter() - t_start
    return report
