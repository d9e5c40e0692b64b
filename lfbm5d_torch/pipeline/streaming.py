"""Batched denoising of many light fields: a port of
`lfbm5d_tpu/pipeline/streaming.py`.

Whole light fields are independent, so a batch is a host loop over its LFs:
LF i runs `run_bm5d` on `devices[i % len(devices)]`, as the reference's
per-LF loop over its mesh's devices does, with no collectives inside an LF.
Kernel launches are asynchronous, so the host queues LF i + 1 on the next
card while LF i runs. The reference's vmapped XLA paths and execution tiers
are TPU machinery with no counterpart here.

Failure isolation: each LF's call is retried `retries` times, then, with
on_fail='identity', replaced by the identity estimate (the noisy input as
both basic and final) and reported, so one faulted LF does not sink the
batch.
"""

from __future__ import annotations

import torch

from lfbm5d_torch.config import DenoiseParams
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.pipeline.denoise import _dtype, run_bm5d


def _run_with_retry(call, args, retries: int, on_fail: str, fallback):
    """Retry a per-LF device call, then degrade per `on_fail`: 'raise'
    re-raises; 'identity' substitutes `fallback()`. Returns (result,
    n_attempts, error_or_None)."""
    err = None
    for attempt in range(retries + 1):
        try:
            return call(*args), attempt + 1, None
        except Exception as e:  # device faults, out of memory, ...
            err = e
    if on_fail == "identity":
        return fallback(), retries + 1, err
    raise err


def denoise_batch(lfs, params: DenoiseParams, devices=None,
                  dtype: str = "float32", engine: str = "auto",
                  retries: int = 0, on_fail: str = "raise",
                  return_report: bool = False):
    """Denoise a batch of LFs [B, aH, aW, H, W, C] (an array, a tensor or a
    sequence of LFs of one shape).

    devices: the devices the LFs go to in turn (`parallel.make_devices`);
    None: the batch tensor's device, or the CUDA card for an array (raises
    without one; pass devices=['cpu'] to run on the host). Returns
    (basic, final) batches stacked on devices[0]; with return_report=True
    also a list of {index, attempts, error} entries for the LFs that fell
    back to the identity estimate. engine: run_bm5d's ('auto', 'auto_bf16'
    or 'torch').
    """
    if on_fail not in ("raise", "identity"):
        raise ValueError(f"on_fail must be 'raise' or 'identity', got "
                         f"{on_fail!r}")
    if devices is None:
        devices = [resolve_device(None, lfs)]
    else:
        devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("denoise_batch needs at least one device")
    if not torch.is_tensor(lfs) and not hasattr(lfs, "shape"):
        lfs = torch.stack([torch.as_tensor(x) for x in lfs])
    dt = _dtype(dtype)
    report: list[dict] = []
    basics, finals = [], []
    for i in range(len(lfs)):
        dev = devices[i % len(devices)]
        lf_i = torch.as_tensor(lfs[i], dtype=dt, device=dev)
        (basic, final), attempts, err = _run_with_retry(
            lambda x: run_bm5d(x, params, dtype=dtype, engine=engine),
            (lf_i,), retries, on_fail, lambda x=lf_i: (x, x))
        if err is not None:
            report.append({"index": i, "attempts": attempts,
                           "error": repr(err)})
        basics.append(basic)
        finals.append(final)
    d0 = devices[0]
    out = (torch.stack([b.to(d0) for b in basics]),
           torch.stack([f.to(d0) for f in finals]))
    return (out, report) if return_report else out
