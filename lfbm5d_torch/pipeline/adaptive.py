"""Content-adaptive preset selection: a port of
`lfbm5d_tpu/pipeline/adaptive.py`, at the light-field level and as the
region composite.

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
guard as a host array.

The region composite (`denoise_region_adaptive`, the CLI's
`--preset adaptive-region`) denoises the whole LF at `matched`, re-denoises
only a bounding crop of the probe's weak-texture blocks at `robust`, and
feathers the crop over the matched output (the reference module explains
the margins and the fallbacks to the LF-level route).
"""

from __future__ import annotations

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams, preset_denoise_params
from lfbm5d_torch.device import resolve_device
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


# Boundary-effect width of the two-step pipeline: a pixel's output draws on
# reference patches up to p-grid distance n away, whose groups span patches
# up to n + nd further; beyond n + (n + nd) + k the crop interior is
# context-complete. robust: n=16, nd=1, k=8 -> 41.
REGION_MARGIN = 48
# Crop dims round up to this multiple (a few shapes serve repeated calls).
REGION_ROUND_TO = 32
# Crop area fraction above which region mode degenerates to the LF level.
REGION_FULL_ROBUST_FRAC = 0.7
# Fewer flagged blocks than this is measurement noise, not a weak region.
REGION_MIN_WEAK_BLOCKS = 12


def static_region_box(flag_map: np.ndarray, h: int, w: int, block: int = 8,
                      margin: int = REGION_MARGIN,
                      round_to: int = REGION_ROUND_TO) -> tuple | None:
    """Pixel bounding box (y0, y1, x0, x1) of the flagged blocks (the weak
    map; any bool block map works), expanded by `margin` and rounded up to
    `round_to` multiples within the frame. None if no block is flagged."""
    ys, xs = np.nonzero(flag_map)
    if ys.size == 0:
        return None
    y0 = max(int(ys.min()) * block - margin, 0)
    y1 = min((int(ys.max()) + 1) * block + margin, h)
    x0 = max(int(xs.min()) * block - margin, 0)
    x1 = min((int(xs.max()) + 1) * block + margin, w)

    def round_span(lo, hi, limit):
        want = min(-((hi - lo) // -round_to) * round_to, limit)
        grow = want - (hi - lo)
        lo = max(lo - grow // 2, 0)
        hi = min(lo + want, limit)
        return hi - want, hi

    y0, y1 = round_span(y0, y1, h)
    x0, x1 = round_span(x0, x1, w)
    return y0, y1, x0, x1


def _feather(ch: int, cw: int, box, h: int, w: int,
             margin: int = REGION_MARGIN) -> np.ndarray:
    """[ch, cw] float32 composite weight: 1 in the crop interior, a linear
    ramp to 0 at crop edges that are not image borders (those pixels lack
    full search context in the crop and sit where matched already
    agrees)."""
    y0, y1, x0, x1 = box
    m = float(margin)

    def ramp(n, lo_open, hi_open):
        d_lo = np.arange(n, dtype=np.float32) + 0.5
        r = np.ones(n, np.float32)
        if lo_open:
            r = np.minimum(r, d_lo / m)
        if hi_open:
            r = np.minimum(r, d_lo[::-1] / m)
        return r

    wy = ramp(ch, y0 > 0, y1 < h)
    wx = ramp(cw, x0 > 0, x1 < w)
    return np.minimum(wy[:, None], wx[None, :])


def denoise_region_adaptive(noisy, sigma: float, *, engine: str = "auto",
                            dtype: str = "float32", device=None,
                            block: int = 8, margin: int = REGION_MARGIN,
                            round_to: int = REGION_ROUND_TO,
                            full_robust_frac: float = REGION_FULL_ROBUST_FRAC,
                            min_weak_blocks: int = REGION_MIN_WEAK_BLOCKS,
                            params_matched: DenoiseParams | None = None,
                            params_robust: DenoiseParams | None = None):
    """Probe-localised preset mixing: `matched` where texture is reliable
    for block matching (or flat), `robust` on the weak-texture region,
    feather-composited.

    noisy: [aH, aW, H, W, C] in [0, 255] (array or tensor); device and
    engine ('auto', 'auto_bf16' or 'torch') as for run_bm5d (device None:
    the tensor's device, or the CUDA card). Returns (basic,
    final, info) with info's route ('matched' | 'robust' | 'region'), the
    probe stats, and, where a box was found, the crop box and its area
    fraction. params_matched / params_robust override the two presets.
    """
    from lfbm5d_torch.pipeline.denoise import _dtype, run_bm5d

    x = torch.as_tensor(noisy, dtype=_dtype(dtype),
                        device=resolve_device(device, noisy))
    h, w = int(x.shape[2]), int(x.shape[3])
    stats, maps = probe_maps(_probe_source(x), sigma, block)
    p_m = params_matched or preset_denoise_params("matched", sigma)
    p_r = params_robust or preset_denoise_params("robust", sigma)

    def lf_level():
        # the LF-level router's decision, as select_preset makes it
        if stats["weak_fraction"] >= WEAK_FRACTION_THRESHOLD:
            return (*run_bm5d(x, p_r, dtype, engine), "robust")
        return (*run_bm5d(x, p_m, dtype, engine), "matched")

    wmap = maps["weak"]
    box = (static_region_box(wmap, h, w, block, margin, round_to)
           if int(wmap.sum()) >= min_weak_blocks else None)
    if box is None:
        basic, final, mode = lf_level()
        return basic, final, {"mode": mode, "stats": stats}
    y0, y1, x0, x1 = box
    area_frac = (y1 - y0) * (x1 - x0) / float(h * w)
    if area_frac >= full_robust_frac:
        # the crop saves nothing: strong content with scattered weak blocks
        # stays on matched, only weak content gets full-frame robust
        basic, final, mode = lf_level()
        return basic, final, {"mode": mode, "stats": stats, "box": box,
                              "area_frac": round(area_frac, 3)}

    basic_m, final_m = run_bm5d(x, p_m, dtype, engine)
    crop = x[:, :, y0:y1, x0:x1].contiguous()
    basic_r, final_r = run_bm5d(crop, p_r, dtype, engine)
    wgt = torch.as_tensor(_feather(y1 - y0, x1 - x0, box, h, w, margin),
                          dtype=x.dtype, device=x.device)[:, :, None]

    def composite(full, region):
        out = full.clone()
        out[:, :, y0:y1, x0:x1] = (wgt * region
                                   + (1.0 - wgt) * full[:, :, y0:y1, x0:x1])
        return out

    info = {"mode": "region", "stats": stats, "box": box,
            "area_frac": round(area_frac, 3),
            "crop_shape": [y1 - y0, x1 - x0]}
    return composite(basic_m, basic_r), composite(final_m, final_r), info
