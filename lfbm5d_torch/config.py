"""Typed configuration of the port: a copy of `lfbm5d_tpu/config.py`.

The port keeps its own copy so that it never imports the JAX package (whose
package `__init__` pulls in jax); tests/test_torch_config.py holds the two
equal field for field. `from_reference` turns the reference's dataclasses
into these, so one parameter set can feed both packages.

Header of the reference module:

Mirrors the reference CLI's per-step parameter blocks (SURVEY.md §2.9): the
C++ tool takes ~30 positional args with one block of filtering parameters for
the hard-threshold (HT) step and one for the Wiener step. Here each block is a
frozen dataclass so it can be used as a static (hashable) argument to jitted
pipeline builders.

Defaults follow SURVEY.md §2.9/§2.10 (IPOL BM3D lineage):
  N=16 max similar patches (power of two), n=16 self-similarity search
  half-window, nDisp small (Lytro ≈2-6), k=8 patch size, p=3 reference-patch
  step, lambda=2.7 hard threshold, tauMatch 2500 (HT) / 400 (Wiener) on
  normalized SSD in [0,255]^2 units, Kaiser beta=2.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class StepParams:
    """Parameters for one filtering step (HT or Wiener).

    Attributes:
      n_sim: max number of similar patches kept per reference patch (N).
        Must be a power of two; the actual group stack size is truncated to
        the largest power of two <= the number of candidates passing
        ``tau_match`` (SURVEY.md §2.10.4).
      n_search: self-similarity search half-window in the reference SAI (n).
        Candidates live in the (2n+1)^2 window centered on the ref patch.
      n_disp: angular/disparity search half-window (nDisp). For every similar
        patch and every other SAI, the best match is sought in the
        (2*nDisp+1)^2 window centered at the co-located position.
      k: patch size (k x k).
      p: reference-patch grid step; a final row/col is flushed to the image
        boundary (SURVEY.md §2.10.2).
      p_ang: reference-SAI grid step (LFBM5D-TPU extension; 1 = reference
        semantics). The reference algorithm lets EVERY SAI serve as
        reference once (SURVEY.md §2.10.3); p_ang > 1 subsamples the
        reference role onto a strided angular grid with boundary flush
        (the angular analog of p). Groups still span and aggregate into
        ALL SAIs, so every SAI's output keeps contributions from every
        reference pass — total work divides by ~p_ang^2.
      tau_2d: spatial transform on each k x k patch: 'dct' | 'bior'.
      tau_4d: angular transform across the SAI grid axes: 'dct' | 'id'.
      tau_5d: transform along the similarity stack: 'haar' | 'hadamard' | 'dct'.
      tau_match: block-matching threshold on the k^2-normalized SSD
        ([0,255]-scale pixel units squared).
      use_sd: use standard-deviation-based aggregation weights instead of the
        1/(sigma^2 * N_nz) (HT) / 1/(sigma^2 * ||w||^2) (Wiener) weights.
      flat_tau: flat-region fallback threshold (LFBM5D-TPU extension;
        0 = off = reference semantics). When > 0, reference-grid positions
        that are angular-REDUNDANT — the mean squared deviation of every
        view from the angular mean over the k x k patch (channel 0 of the
        BM image, quantized to 1/8 [0,255]^2 units like BM distances) is
        <= flat_tau * sigma_c0^2 — build NO group: where all views already
        agree, the 5D machinery spends its full per-slot cost reconfirming
        that everything matches everything. Pixels no group covers
        (den == 0) take the angular-mean k x k transform-domain fallback
        at finalize (ops/flat.py) — the "flat-region per-SAI fallback"
        reformulation of BASELINE.md, LF-aware. flat_tau multiplies the
        statistic's redundant-content center sigma_c0^2 (A-1)/A (where it
        concentrates to a few percent); useful margins sit around
        1.1-1.2. The fused engine also SKIPS the dead chunks (compaction
        + prefetched live counts), making redundant regions nearly free.
      bm_source: which LF block matching runs on (LFBM5D-TPU extension;
        'auto' = reference semantics). For the HT step BM always runs on
        the noisy LF; for the Wiener step 'auto' runs BM on the basic
        estimate (SURVEY.md §2.10 step 2) while 'noisy' runs it on the
        noisy LF — the cross-step BM-reuse semantics (with BM geometry and
        tau_match equal across steps the Wiener tables become identical to
        the HT step's). MEASURED DEAD END for the matched preset: BM on
        noisy costs −0.31 dB at the flagship anchor regardless of
        re-thresholding (experiments/bm_reuse_probe.py, BASELINE.md
        round-5) — the Wiener step's BM-on-basic earns its ~20% of device
        time. The flag stays as the measured record and for research use;
        no preset sets it.
    """

    n_sim: int = 16
    n_search: int = 16
    n_disp: int = 2
    k: int = 8
    p: int = 3
    p_ang: int = 1
    tau_2d: str = "dct"
    tau_4d: str = "dct"
    tau_5d: str = "haar"
    tau_match: float = 2500.0
    use_sd: bool = False
    flat_tau: float = 0.0
    bm_source: str = "auto"

    def __post_init__(self):
        if self.n_sim < 1 or (self.n_sim & (self.n_sim - 1)) != 0:
            raise ValueError(f"n_sim must be a power of two, got {self.n_sim}")
        if self.p_ang < 1:
            raise ValueError(f"p_ang must be >= 1, got {self.p_ang}")
        if self.tau_2d not in ("dct", "bior"):
            raise ValueError(f"tau_2d must be 'dct' or 'bior', got {self.tau_2d!r}")
        if self.tau_4d not in ("dct", "id"):
            raise ValueError(f"tau_4d must be 'dct' or 'id', got {self.tau_4d!r}")
        if self.tau_5d not in ("haar", "hadamard", "dct"):
            raise ValueError(
                f"tau_5d must be 'haar', 'hadamard' or 'dct', got {self.tau_5d!r}"
            )
        if self.bm_source not in ("auto", "noisy"):
            raise ValueError(
                f"bm_source must be 'auto' or 'noisy', got {self.bm_source!r}"
            )

    @property
    def pad(self) -> int:
        """Symmetric padding applied to every SAI before this step.

        n_search covers the self-BM window; n_disp more keeps every angular
        disparity window of every similar patch in-bounds (spec choice
        documented in SURVEY.md §2.10.2 discussion; the reference symmetrizes
        by the search half-window).
        """
        return self.n_search + self.n_disp

    def replace(self, **kw) -> "StepParams":
        return dataclasses.replace(self, **kw)


def default_ht_params() -> StepParams:
    return StepParams(tau_match=2500.0)


def default_wiener_params() -> StepParams:
    return StepParams(tau_match=400.0)


@dataclass(frozen=True)
class DenoiseParams:
    """Full two-step pipeline parameters (reference `run_bm5d` contract)."""

    sigma: float = 25.0
    lambda_3d: float = 2.7
    color_space: str = "opp"  # 'opp' | 'yuv' | 'ycbcr' | 'rgb'
    ht: StepParams = dataclasses.field(default_factory=default_ht_params)
    wiener: StepParams = dataclasses.field(default_factory=default_wiener_params)
    # Compute chunk of reference patches processed per inner iteration; purely
    # a performance/memory knob, never changes results.
    chunk: int = 256

    def __post_init__(self):
        if self.color_space not in ("opp", "yuv", "ycbcr", "rgb"):
            raise ValueError(f"unknown color_space {self.color_space!r}")

    def replace(self, **kw) -> "DenoiseParams":
        return dataclasses.replace(self, **kw)


def default_denoise_params(sigma: float = 25.0) -> DenoiseParams:
    return DenoiseParams(sigma=sigma)


# Named parameter presets: StepParams field overrides applied to BOTH steps
# (tau_match stays per-step: 2500 HT / 400 Wiener). Single source of truth
# for the CLI, bench.py, and the content-adaptive selector
# (pipeline/adaptive.py). Measurement record: BASELINE.md knee sweeps.
PRESETS: dict = {
    # reference-default parameters (SURVEY.md §2.9)
    "default": {},
    # throughput preset: coarser reference grid, smaller windows
    "fast": dict(n_sim=8, n_search=8, n_disp=2, p=6),
    # fastest preset measured at-or-above reference-default PSNR on the
    # bench LF at the 9x9 flagship shape (28.417 vs 28.416 dB at 434x625,
    # ~120x the default's speed with the flat-region fallback on; the
    # fallback is quality-POSITIVE where it triggers — +0.18 dB on
    # half-flat content, BASELINE.md). Content caveat: loses up to
    # ~0.4 dB on low-disparity LFs — 'robust' covers that regime.
    "matched": dict(n_sim=8, n_search=16, n_disp=1, p=8, p_ang=4,
                    flat_tau=1.3),
    # within 0.05 dB of reference-default on EVERY tested content class
    # (worst case -0.046 dB on a static-background LF) at ~4x default speed
    "robust": dict(n_sim=16, n_search=16, n_disp=1, p=3, p_ang=2),
}


# Named SR iteration schedules (n_iter, sigma_init; sigma_final stays 1.0).
# Measured at the flagship x2 shape (experiments/sr_knee.py, BASELINE.md
# round-5): with the matched step preset the quality knee is 5 iterations
# from sigma_init=8 (31.599 dB vs 31.608 at 8 iters and 31.507 at 3;
# sigma_init 12/16 are never better at equal iterations). The reference-
# style schedule (10 iterations from sigma 12, SURVEY.md §2.10 SR) remains
# the 'default' preset's schedule.
SR_SCHEDULES: dict = {
    "default": dict(n_iter=10, sigma_init=12.0),
    "fast": dict(n_iter=3, sigma_init=8.0),
    "matched": dict(n_iter=5, sigma_init=8.0),
    "robust": dict(n_iter=5, sigma_init=12.0),
}


def preset_step_params(name: str, tau_match: float, **extra) -> StepParams:
    """StepParams for a named preset (tau_match: 2500.0 HT / 400.0 Wiener)."""
    over = dict(PRESETS[name])
    over.update(extra)
    return StepParams(tau_match=tau_match, **over)


def preset_denoise_params(name: str, sigma: float, **kw) -> DenoiseParams:
    """Full two-step DenoiseParams for a named preset."""
    return DenoiseParams(
        sigma=sigma,
        ht=preset_step_params(name, 2500.0),
        wiener=preset_step_params(name, 400.0),
        **kw,
    )


@dataclass(frozen=True)
class SRParams:
    """Super-resolution mode (ICIP18): bicubic init + [filter, back-project] loop.

    sigma_init/sigma_final define the decreasing sigma schedule over n_iter
    iterations (linear in sigma, SURVEY.md §2.10 SR paragraph).
    """

    scale: int = 2
    n_iter: int = 10
    sigma_init: float = 12.0
    sigma_final: float = 1.0
    color_space: str = "opp"
    lambda_3d: float = 2.7
    ht: StepParams = dataclasses.field(default_factory=default_ht_params)
    wiener: StepParams = dataclasses.field(default_factory=default_wiener_params)
    # Back-projection gain.
    bp_gain: float = 1.0
    # Gaussian pre-blur std of the decimation model (0 = plain box average;
    # >0 = anti-aliased blur+decimate, the classical IBP model).
    decimation_blur: float = 0.0
    chunk: int = 256

    def replace(self, **kw) -> "SRParams":
        return dataclasses.replace(self, **kw)


def from_reference(params):
    """The port's StepParams, DenoiseParams or SRParams with the fields of
    `params`, any object carrying the reference dataclass's fields (e.g. a
    `lfbm5d_tpu.config` instance)."""
    if hasattr(params, "scale"):
        kw = {f.name: getattr(params, f.name)
              for f in dataclasses.fields(SRParams)}
        kw["ht"] = from_reference(params.ht)
        kw["wiener"] = from_reference(params.wiener)
        return SRParams(**kw)
    if hasattr(params, "ht"):
        kw = {f.name: getattr(params, f.name)
              for f in dataclasses.fields(DenoiseParams)}
        kw["ht"] = from_reference(params.ht)
        kw["wiener"] = from_reference(params.wiener)
        return DenoiseParams(**kw)
    return StepParams(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(StepParams)})
