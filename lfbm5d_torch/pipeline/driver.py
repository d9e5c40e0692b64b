"""Denoise many on-disk light fields over a list of devices: a port of
`lfbm5d_tpu/pipeline/driver.py`.

Input directories go through `denoise_batch` in batches of len(devices)
LFs (one LF per device); a batch that fails is retried LF by LF, so one
corrupt input cannot sink the job, and each LF's status is reported.
"""

from __future__ import annotations

import numpy as np

from lfbm5d_torch.config import DenoiseParams
from lfbm5d_torch.lf.io import fetch_rounded, load_lf, save_lf


def stream_directories(inputs: list[str], outputs: list[str], pattern: str,
                       a_h: int, a_w: int, params: DenoiseParams,
                       devices=None, bit_depth: int = 8,
                       retries: int = 1) -> list[dict]:
    """Denoise each input LF directory into the matching output directory.

    devices: as for `denoise_batch` (None: the CUDA card). Returns a per-LF
    status list: {"input", "ok", "error"?}.
    """
    from lfbm5d_torch.pipeline.streaming import denoise_batch

    if len(inputs) != len(outputs):
        raise ValueError("inputs and outputs must pair up")
    group = len(devices) if devices else 1
    status: list[dict] = [{"input": p, "ok": False} for p in inputs]

    def run_batch(idxs: list[int]) -> None:
        lfs = np.stack([load_lf(inputs[i], pattern, a_h, a_w) for i in idxs])
        _, finals = denoise_batch(lfs, params, devices=devices)
        for j, i in enumerate(idxs):
            save_lf(fetch_rounded(finals[j], bit_depth), outputs[i], pattern,
                    bit_depth=bit_depth)
            status[i]["ok"] = True

    for b in range(0, len(inputs), group):
        idxs = list(range(b, min(b + group, len(inputs))))
        try:
            run_batch(idxs)
        except Exception as batch_err:  # retry per LF to isolate the culprit
            for i in idxs:
                done = False
                for _ in range(max(retries, 1)):
                    try:
                        run_batch([i])
                        done = True
                        break
                    except Exception as e:
                        status[i]["error"] = str(e)
                if not done and "error" not in status[i]:
                    status[i]["error"] = str(batch_err)
    return status
