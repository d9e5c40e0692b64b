"""Named per-stage wall times for the CLI's report: a port of
`lfbm5d_tpu/utils/timing.py::StageTimer`.

The reference's `device_fence` works around a remote TPU platform whose
`block_until_ready` returned early; here a stage that ends in device work
calls `device_fence(x)`, which is `torch.cuda.synchronize` on x's card (a
host tensor needs none). For a breakdown by kernel use torch.profiler
(`python chip_smoke.py --profile`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class StageTimer:
    def __init__(self):
        self._times: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name] = (self._times.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def seconds(self, name: str) -> float:
        return self._times.get(name, 0.0)

    def items(self):
        return self._times.items()


def device_fence(x) -> None:
    """Block until the work that produced x (a tensor, or a tuple or list
    ending in one) has finished on its card."""
    while isinstance(x, (tuple, list)):
        x = x[-1]
    if torch.is_tensor(x) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
