"""Where the port's entry points run: the CUDA card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None, x=None) -> torch.device:
    """`device` when given; else the device of `x` when it is a tensor; else
    the CUDA card. Raises when that is a CUDA device and no card is present:
    nothing runs on the host unless the caller asks for device='cpu'."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: pass device='cpu' to "
                           "run on the host")
    return dev
