"""Content-adaptive preset selection at the light-field level: a port of
`lfbm5d_tpu/pipeline/adaptive.py` (lines 1-192 of it).

What the probe measures and why the thresholds sit where they do is in the
reference module's docstring. In short: the `matched` preset loses quality
only on WEAK-TEXTURE content (block energy too strong for the flat
fallback, too weak for reliable block matching at p=8/N=8/p_ang=4), so

  weak_fraction = (informative blocks with one-block-shift energy
                   <= 24 vb) / (informative blocks),
  informative: energy > 8 vb,  vb = block-mean noise variance 2 sigma^2/64,

measured on 8x8 block means of channel 0 of the two extreme corner SAIs,
routes to `robust` at >= 0.66 and to `matched` below.

The probe runs on the host in numpy. A tensor LF is probed through its two
corner SAIs only, quantised to uint8 on its device (`lf.io.fetch_rounded`),
never the whole LF; a 1x1 angular grid takes the same degenerate-input
guard as a host array. The reference's region composite
(`denoise_region_adaptive`) is not ported: `adaptive-region` routes at the
light-field level (ROADMAP.md A6).
"""

from __future__ import annotations

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams, preset_denoise_params
from lfbm5d_torch.lf.io import fetch_rounded

# Decision threshold on the weak-texture block fraction.
WEAK_FRACTION_THRESHOLD = 0.66
# Weak bound: informative blocks at-or-below this multiple of the
# block-mean noise variance (2 sigma^2 / 64) are too weak for reliable
# aggressive-preset BM.
_WEAK_FACTOR = 24.0
# A block's one-block-shift content energy must exceed this multiple of the
# block-mean noise variance to count as informative.
_INFORMATIVE_FACTOR = 8.0
# An informative block is static when the extreme-pair difference is below
# max(_STATIC_NOISE_FACTOR * noise, _STATIC_CONTENT_FRACTION * g).
_STATIC_NOISE_FACTOR = 6.0
_STATIC_CONTENT_FRACTION = 0.15


def probe_maps(lf, sigma: float, block: int = 8) -> tuple[dict, dict]:
    """Angular-redundancy / texture-strength probe of a (noisy) light field.

    lf: [aH, aW, H, W, C] host array in [0, 255]; sigma: AWGN std on the
    [0, 255] scale.

    Returns (stats, maps):
      stats = {weak_fraction, static_fraction, n_informative, n_blocks,
               noise_var_block}
      maps["weak"] = [H//block, W//block] bool: informative blocks whose
        one-block-shift energy is in the weak band.
      maps["static"] = informative AND angularly-static blocks (diagnostic).
    """
    lf = np.asarray(lf)
    a_h, a_w = lf.shape[:2]
    b = block
    p0 = lf[0, 0, :, :, 0].astype(np.float64)
    p1 = lf[a_h - 1, a_w - 1, :, :, 0].astype(np.float64)
    hb, wb = (p0.shape[0] // b) * b, (p0.shape[1] // b) * b
    vb = 2.0 * sigma * sigma / (b * b)
    empty = np.zeros((max(hb // b, 0), max(wb // b, 0)), bool)
    if hb == 0 or wb == 0 or (a_h == 1 and a_w == 1):
        stats = {"weak_fraction": 0.0, "static_fraction": 1.0,
                 "n_informative": 0, "n_blocks": 0, "noise_var_block": vb}
        return stats, {"weak": empty, "static": empty}

    def block_means(p):
        return p[:hb, :wb].reshape(hb // b, b, wb // b, b).mean(axis=(1, 3))

    m0 = block_means(p0)
    m1 = block_means(p1)
    d = (m0 - m1) ** 2
    g = np.zeros_like(m0)
    g[:-1, :] = np.maximum(g[:-1, :], (m0[:-1, :] - m0[1:, :]) ** 2)
    g[1:, :] = np.maximum(g[1:, :], (m0[1:, :] - m0[:-1, :]) ** 2)
    g[:, :-1] = np.maximum(g[:, :-1], (m0[:, :-1] - m0[:, 1:]) ** 2)
    g[:, 1:] = np.maximum(g[:, 1:], (m0[:, 1:] - m0[:, :-1]) ** 2)

    informative = g > _INFORMATIVE_FACTOR * vb
    weak_map = informative & (g <= _WEAK_FACTOR * vb)
    n_inf = int(informative.sum())
    if n_inf < 8:
        # featureless content: angularly redundant by definition (the flat
        # fallback covers it; matched is safe regardless of weak blocks)
        stats = {"weak_fraction": 0.0, "static_fraction": 1.0,
                 "n_informative": n_inf, "n_blocks": int(d.size),
                 "noise_var_block": vb}
        return stats, {"weak": np.zeros_like(informative),
                       "static": np.zeros_like(informative)}
    static_map = informative & (
        d < np.maximum(_STATIC_NOISE_FACTOR * vb,
                       _STATIC_CONTENT_FRACTION * g)
    )
    stats = {
        "weak_fraction": float(weak_map.sum() / n_inf),
        "static_fraction": float(static_map.sum() / n_inf),
        "n_informative": n_inf,
        "n_blocks": int(d.size),
        "noise_var_block": vb,
    }
    return stats, {"weak": weak_map, "static": static_map}


def _probe_source(lf):
    """Host view of an LF for probe_maps, which reads only lf[0, 0] and
    lf[-1, -1]: a host array as it is; a tensor as those two SAIs, quantised
    on its device and stacked as a 2x1 grid; a 1x1 grid as zeros of its
    shape (nothing fetched), so probe_maps' degenerate guard applies as it
    does to the host array."""
    if not torch.is_tensor(lf):
        return np.asarray(lf)
    if lf.shape[0] == 1 and lf.shape[1] == 1:
        return np.zeros(tuple(lf.shape))
    pair = torch.stack([lf[0, 0], lf[-1, -1]])
    return np.asarray(fetch_rounded(pair, 8), np.float64)[:, None]


def content_stats(lf, sigma: float, block: int = 8) -> dict:
    """Probe stats only (see probe_maps; a tensor LF is probed through its
    two corner SAIs, not the whole LF)."""
    return probe_maps(_probe_source(lf), sigma, block)[0]


def select_preset(lf, sigma: float) -> tuple[str, dict]:
    """('matched' | 'robust', probe stats) for a noisy LF at known sigma."""
    stats = content_stats(lf, sigma)
    name = ("robust" if stats["weak_fraction"] >= WEAK_FRACTION_THRESHOLD
            else "matched")
    return name, stats


def adaptive_denoise_params(lf, sigma: float,
                            **kw) -> tuple[DenoiseParams, str, dict]:
    """DenoiseParams chosen by the content probe, plus (name, stats)."""
    name, stats = select_preset(lf, sigma)
    return preset_denoise_params(name, sigma, **kw), name, stats
