"""AWGN synthesis with pinned RNG: a copy of `lfbm5d_tpu/lf/noise.py::
add_noise_np` (reference: mt19937ar.c + add_noise), and `add_noise`, the
counterpart of its device version (a torch.Generator in place of the JAX
key).

The reference adds i.i.d. Gaussian noise of std sigma (on the [0,255] scale)
to a clean LF for experiments. This is the numpy version (pinned
`np.random.Generator`); the same seed gives the same noise as the JAX
package's copy. Exact bitwise parity with the C Mersenne
Twister is impossible to verify (empty reference mount, SURVEY.md §0) and is
not required: tests pin their own RNG.
"""

from __future__ import annotations

import numpy as np
import torch


def add_noise_np(
    lf: np.ndarray, sigma: float, seed: int = 0, rng_kind: str = "pcg64"
) -> np.ndarray:
    """AWGN of std `sigma`. rng_kind='mt19937' uses the Mersenne Twister
    (the reference's RNG family, component #7) for lineage parity; the
    default PCG64 is numpy's modern generator."""
    if rng_kind == "mt19937":
        rng = np.random.Generator(np.random.MT19937(seed))
    else:
        rng = np.random.default_rng(seed)
    out = np.asarray(lf, dtype=np.float64) + sigma * rng.standard_normal(lf.shape)
    return out



def add_noise(generator: torch.Generator, lf, sigma: float) -> torch.Tensor:
    """lf + AWGN of std `sigma` in float32, drawn from `generator` on its
    device (lf, an array or tensor, is moved there): the same generator
    state gives the same noise."""
    x = torch.as_tensor(lf, dtype=torch.float32, device=generator.device)
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
    return x + sigma * noise
