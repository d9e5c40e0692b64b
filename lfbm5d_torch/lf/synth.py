"""Synthetic light-field generator for tests and benchmarks: a copy of
`lfbm5d_tpu/lf/synth.py`, bit-equal to it (tests/test_torch_config.py).

No LF datasets ship with this machine (no network, SURVEY.md §0), so tests and
the benchmark harness generate light fields with genuine LF structure: a
textured background plane and a textured foreground plane, each shifted per
sub-aperture image by disparity * (angular offset from center). This gives the
disparity-compensated angular block matching something real to find.

Returns float64 arrays in [0, 255], shape [aH, aW, H, W, C].
"""

from __future__ import annotations

import numpy as np


def _smooth_texture(rng: np.random.Generator, h: int, w: int, blur: int) -> np.ndarray:
    """Low-pass filtered uniform noise in [0,1] via separable box filters."""
    t = rng.random((h, w))
    for _ in range(2):
        # separable box blur with wraparound (cheap, dependency-free)
        k = np.ones(blur) / blur
        t = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 0, t)
        t = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), 1, t)
    t = t - t.min()
    m = t.max()
    if m > 0:
        t = t / m
    return t


def synthetic_lf(
    a_h: int = 3,
    a_w: int = 3,
    h: int = 32,
    w: int = 40,
    channels: int = 1,
    disp_bg: int = 1,
    disp_fg: int = 2,
    seed: int = 0,
    flat_frac: float = 0.0,
) -> np.ndarray:
    """Two-plane textured light field with integer per-plane disparity.

    flat_frac > 0 replaces the LEFT flat_frac of the background texture's
    columns with a constant (its mean there): a genuinely flat region that
    stays flat in every view while keeping the plane's disparity structure —
    the content class the flat-region fallback (StepParams.flat_tau)
    targets. 0 (default) reproduces the historical generator exactly.
    """
    rng = np.random.default_rng(seed)
    max_disp = max(abs(disp_bg), abs(disp_fg)) * max(a_h, a_w)
    ch, cw = h + 2 * max_disp + 2, w + 2 * max_disp + 2

    lf = np.zeros((a_h, a_w, h, w, channels), dtype=np.float64)
    cy, cx = (a_h - 1) / 2.0, (a_w - 1) / 2.0

    # foreground occupies a centered ellipse of the frame (channel-invariant;
    # hoisted out of the loop — values identical to the original per-channel
    # recomputation)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((yy - h / 2) / (h / 3.0)) ** 2 + ((xx - w / 2) / (w / 3.0)) ** 2 < 1.0

    for c in range(channels):
        bg = _smooth_texture(rng, ch, cw, blur=3) * 220.0 + 20.0
        fg = _smooth_texture(rng, ch, cw, blur=2) * 200.0 + 40.0
        if flat_frac > 0.0:
            cols = int(cw * flat_frac)
            bg[:, :cols] = bg[:, :cols].mean()
        # per-channel contiguous buffer: writing each SAI into the strided
        # lf[s, t, :, :, c] view measured ~12 s at flagship size
        chan = np.empty((a_h, a_w, h, w), dtype=np.float64)
        for s in range(a_h):
            for t in range(a_w):
                dy_bg = int(round(disp_bg * (s - cy)))
                dx_bg = int(round(disp_bg * (t - cx)))
                dy_fg = int(round(disp_fg * (s - cy)))
                dx_fg = int(round(disp_fg * (t - cx)))
                o = max_disp + 1
                bg_view = bg[o + dy_bg : o + dy_bg + h, o + dx_bg : o + dx_bg + w]
                fg_view = fg[o + dy_fg : o + dy_fg + h, o + dx_fg : o + dx_fg + w]
                np.copyto(chan[s, t], np.where(mask, fg_view, bg_view))
        lf[..., c] = chan
    np.clip(lf, 0.0, 255.0, out=lf)  # in-place: the copying clip was ~10 s
    return lf


def synthetic_lf_multi(
    a_h: int = 9,
    a_w: int = 9,
    h: int = 64,
    w: int = 64,
    channels: int = 3,
    disps: tuple = (0.5, 1.5, 3.0),
    seed: int = 0,
    flat_frac: float = 0.0,
    texture_grad: float = 0.0,
    blob_frac: float = 0.4,
) -> np.ndarray:
    """Multi-plane occluded light field (the broadened content family).

    `synthetic_lf` is a two-plane scene with one ellipse occluder — every
    preset constant was originally tuned on it alone (round-3 verdict's
    robustness concern). This generator adds the content classes real LF
    datasets contain:

    * **>= 3 disparity layers** — ``disps`` lists per-layer disparity,
      back to front (layer 0 = full background). Fractional disparities
      round per SAI, so shift patterns vary across the angular grid.
    * **Moving occlusions** — each foreground layer is an irregular blob
      (thresholded smooth noise) that shifts WITH its own disparity, so
      occlusion boundaries genuinely move across views and the angular
      stack is inconsistent near them (the hard case for 5D filtering).
    * **Texture gradients** — ``texture_grad`` in [0, 1] ramps texture
      contrast from (1 - texture_grad) at the left edge to full at the
      right, mixing near-flat and strongly-textured content in one frame.
    * **Mixed static/texture** — ``flat_frac`` keeps the two-plane
      generator's genuinely-flat strip; a 0.0 entry in ``disps`` makes a
      static (zero-disparity) layer.

    Returns float64 in [0, 255], shape [aH, aW, H, W, C].
    """
    if len(disps) < 1:
        raise ValueError("disps must name at least the background layer")
    rng = np.random.default_rng(seed)
    max_disp = int(np.ceil(max(abs(float(d)) for d in disps) * max(a_h, a_w)))
    ch, cw = h + 2 * max_disp + 2, w + 2 * max_disp + 2
    cy, cx = (a_h - 1) / 2.0, (a_w - 1) / 2.0
    o = max_disp + 1

    def grade(tex: np.ndarray) -> np.ndarray:
        if texture_grad <= 0.0:
            return tex
        g = (1.0 - texture_grad) + texture_grad * np.linspace(0.0, 1.0, cw)
        m = tex.mean()
        return m + (tex - m) * g[None, :]

    lf = np.zeros((a_h, a_w, h, w, channels), dtype=np.float64)
    # blob masks are channel-invariant (a real occluder hides all channels)
    masks = []
    for li in range(1, len(disps)):
        field = _smooth_texture(rng, ch, cw, blur=max(h, w) // 6 + 3)
        thresh = np.quantile(field, 1.0 - blob_frac)
        masks.append(field > thresh)

    for c in range(channels):
        texs = []
        for li in range(len(disps)):
            blur = 3 if li == 0 else 2
            span = 220.0 - 15.0 * li  # layers differ in brightness range
            tex = _smooth_texture(rng, ch, cw, blur=blur) * span + 20.0
            if li == 0 and flat_frac > 0.0:
                cols = int(cw * flat_frac)
                tex[:, :cols] = tex[:, :cols].mean()
            texs.append(grade(tex))
        chan = np.empty((a_h, a_w, h, w), dtype=np.float64)
        for s in range(a_h):
            for t in range(a_w):
                def view(src: np.ndarray, d: float) -> np.ndarray:
                    dy = int(round(float(d) * (s - cy)))
                    dx = int(round(float(d) * (t - cx)))
                    return src[o + dy : o + dy + h, o + dx : o + dx + w]

                img = view(texs[0], disps[0])
                for li in range(1, len(disps)):
                    img = np.where(view(masks[li - 1], disps[li]),
                                   view(texs[li], disps[li]), img)
                np.copyto(chan[s, t], img)
        lf[..., c] = chan
    np.clip(lf, 0.0, 255.0, out=lf)
    return lf
