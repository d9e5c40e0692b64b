"""The devices a batch of light fields is spread over: the counterpart of
`lfbm5d_tpu/parallel/mesh.py::make_mesh`.

Whole light fields are independent, so a batch needs no mesh and no
collectives: `pipeline/streaming.py::denoise_batch` sends LF i to
`devices[i % len(devices)]`. The list holds the CUDA cards unless the
caller asks for the host; it never falls back to the CPU when no card is
found.
"""

from __future__ import annotations

import torch


def make_devices(n_devices: int | None = None,
                 device_type: str = "cuda") -> list[torch.device]:
    """The first `n_devices` CUDA cards (default: all of them), or, with
    device_type='cpu', the host `n_devices` times (default once: a list
    that only exercises the round-robin). Raises when cards are asked for
    and there are none or too few."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("no CUDA device: pass device_type='cpu' to run "
                           "on the host")
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"requested {n} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]
