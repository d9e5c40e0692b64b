"""Two-step HT -> Wiener LFBM5D pipeline in plain torch (reference run_bm5d).

Counterpart of `lfbm5d_tpu.pipeline.denoise`. `_build_step` ports the XLA
engine: per reference SAI, self-BM distances -> stable top-N selection ->
angular argmin maps against every SAI -> chunks of reference patches: one
gather builds the [chunk, N, aH, aW, k, k, C] group -> separable transform ->
HT or Wiener shrinkage -> inverse -> Kaiser*weight scatter-add into the
numerator/denominator accumulators [A, Hp, Wp, C].

Engines (mirroring the reference's `_resolve_engine`):
  'auto'  -> `pipeline.engine.build_kernel_step`, whose kernel wrappers
             launch the CUDA kernels for CUDA tensors and run their plain
             versions for CPU tensors; its route ('fused', 'banked' or
             'two_kernel') follows from the shapes, or from `fused` as in
             the reference (None: by shape; True: the fused family; False:
             the two-kernel path);
  'torch' -> `_build_step` here, plain torch on any device.
Only the reference's 'single' execution tier exists: its launched and banked
tiers work around TPU faults.

Every entry point runs on the CUDA card unless the caller passes
device='cpu' (or a CPU tensor, whose device is taken); without a card a call
that does not ask for the CPU raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lfbm5d_torch.config import DenoiseParams, StepParams
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.lf.color import channel_sigma_scales, color_matrix
from lfbm5d_torch.kernels.gather import sample_doff
from lfbm5d_torch.lf.pad import ind_initialize, pad_lf, ref_sai_grid
from lfbm5d_torch.ops.distances import (
    center_index,
    cross_argmin_all,
    displacements,
    self_distances,
)
from lfbm5d_torch.ops.flat import fallback_shrink_2d, flat_ref_mask
from lfbm5d_torch.ops.match import select_similar
from lfbm5d_torch.ops.shrinkage import filter_groups
from lfbm5d_torch.transforms import matrices as tm
from lfbm5d_torch.transforms.apply import GroupTransforms

ENGINES = ("auto", "torch")


def _dtype(dtype: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[dtype]


@lru_cache(maxsize=None)
def _build_step(sp: StepParams, lambda_3d: float, a_h: int, a_w: int, h: int,
                w: int, c: int, chunk: int, wiener: bool,
                dtype: str = "float32", device: str = "cpu"):
    """One filtering step for a fixed geometry: fn(noisy_p, match_p, sigma_c,
    basic_p) -> (num, den) on padded, SAI-flattened [A, Hp, Wp, C]."""
    k, n, nd, n_sim, pad = sp.k, sp.n_search, sp.n_disp, sp.n_sim, sp.pad
    a = a_h * a_w
    dt = _dtype(dtype)
    dev = torch.device(device)
    ys = ind_initialize(h, k, sp.p) + pad
    xs = ind_initialize(w, k, sp.p) + pad
    t = len(ys) * len(xs)

    def i64(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.long, device=dev)

    ys_d, xs_d = i64(ys), i64(xs)
    pos_y = i64(np.repeat(ys, len(xs)))
    pos_x = i64(np.tile(xs, len(ys)))
    disp_self = i64(displacements(n))
    disp_ang = i64(displacements(nd))
    c_ang = center_index(nd)
    kaiser = torch.as_tensor(tm.kaiser_window(k), dtype=dt, device=dev)
    gt = GroupTransforms.build(sp, a_h, a_w, dtype=dt, device=dev)
    ku = torch.arange(k, device=dev)[:, None]
    kv = torch.arange(k, device=dev)[None, :]
    a_b = torch.arange(a, device=dev)[None, None, :, None, None]
    refs = [int(r) for r in ref_sai_grid(a_h, a_w, sp.p_ang)]

    def step(noisy_p, match_p, sigma_c, basic_p):
        match0 = match_p[..., 0]  # [A, Hp, Wp]
        fmask = None
        if sp.flat_tau > 0:
            # computed on the NOISY LF in both steps (ops/flat.py)
            fmask = flat_ref_mask(noisy_p[..., 0], ys_d, xs_d, k,
                                  sp.flat_tau, sigma_c[0])
        num = torch.zeros_like(noisy_p)
        den = torch.zeros_like(noisy_p)
        for r in refs:
            ref0 = match0[r]
            d_self = self_distances(ref0, ys_d, xs_d, k, n)  # [T, Ds]
            order, lvl, mask = select_similar(d_self, n, sp.tau_match, n_sim)
            if fmask is not None:
                mask = mask & ~fmask[:, None]
            off = disp_self[order]  # [T, N, 2]
            sim_y = pos_y[:, None] + off[..., 0]
            sim_x = pos_x[:, None] + off[..., 1]
            bidx = cross_argmin_all(ref0, match0, k, nd)  # [A, V0, V1]
            ang = sample_doff(bidx, sim_y, sim_x, r, c_ang)  # [T, N, A]

            for s0 in range(0, t, chunk):
                s1 = min(t, s0 + chunk)
                tc = s1 - s0
                clvl = lvl[s0:s1]
                aoff = disp_ang[ang[s0:s1]]  # [Tc, N, A, 2]
                ay = sim_y[s0:s1, :, None] + aoff[..., 0]
                ax = sim_x[s0:s1, :, None] + aoff[..., 1]
                yy = ay[..., None, None] + ku  # [Tc, N, A, k, 1]
                xx = ax[..., None, None] + kv  # [Tc, N, A, 1, k]
                shape = (tc, n_sim, a_h, a_w, k, k, c)
                g = noisy_p[a_b, yy, xx].reshape(shape)
                gb = basic_p[a_b, yy, xx].reshape(shape) if wiener else None
                est, wgt = filter_groups(g, gb, clvl, gt, sigma_c, lambda_3d,
                                         sp.use_sd)
                est = est.reshape(tc, n_sim, a, k, k, c)
                wfull = (
                    wgt[:, None, None, None, None, :]
                    * mask[s0:s1, :, None, None, None, None]
                    * kaiser[None, None, None, :, :, None]
                )  # [Tc, N, 1, k, k, C]
                idx = (a_b, yy, xx)
                num.index_put_(idx, est * wfull, accumulate=True)
                den.index_put_(idx, wfull.expand(est.shape), accumulate=True)
        return num, den

    return step


def _raw_step(sp, lambda_3d, a_h, a_w, h, w, c, chunk, wiener, dtype, engine,
              device, fused=None, doff_mode="direct"):
    if engine == "auto":
        from lfbm5d_torch.pipeline.engine import build_kernel_step

        return build_kernel_step(sp, lambda_3d, a_h, a_w, h, w, c, wiener,
                                 dtype, device, fused, doff_mode)
    if fused is not None:
        raise ValueError("fused selects a route of engine='auto'")
    if doff_mode != "direct":
        raise ValueError("doff_mode selects the disparity sampling of "
                         "engine='auto'")
    if engine == "torch":
        return _build_step(sp, lambda_3d, a_h, a_w, h, w, c, chunk, wiener,
                           dtype, device)
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def _finalize(num, den, pad: int, a_h: int, a_w: int, h: int, w: int,
              fb=None):
    est = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    est = est.reshape(a_h, a_w, *est.shape[1:])
    est = est[:, :, pad:pad + h, pad:pad + w, :]
    if fb is not None:
        # flat-region fallback: pixels no group covered take the 2D estimate
        deni = den.reshape(a_h, a_w, *den.shape[1:])
        deni = deni[:, :, pad:pad + h, pad:pad + w, :]
        est = torch.where(deni > 0, est, fb)
    return est


@lru_cache(maxsize=None)
def _transform_pair(name: str, k: int, dtype: torch.dtype,
                    device: torch.device):
    # cached constants: a fresh host->device copy per run drains the stream
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in tm.transform_pair(name, k))


def _flat_fallback(x, sigma_c, sp: StepParams, lambda_3d: float, pilot=None):
    """Per-SAI 2D fallback estimate for flat_tau > 0 steps (None if off)."""
    if sp.flat_tau <= 0:
        return None
    f2, i2 = _transform_pair(sp.tau_2d, sp.k, x.dtype, x.device)
    return fallback_shrink_2d(x, sigma_c, f2, i2, lambda_3d, pilot)


def _flat_pad(x, pad: int):
    """[aH, aW, H, W, C] -> padded, flattened to [A, Hp, Wp, C]."""
    xp = pad_lf(x, pad)
    return xp.reshape(-1, *xp.shape[2:])


@lru_cache(maxsize=None)
def _sigma_channels(sigma: float, color_space: str, c: int, dtype: str,
                    device="cpu"):
    """Per-channel noise stds [C] (cached, like _transform_pair)."""
    scales = channel_sigma_scales(color_space)[:c] if c == 3 else np.ones((c,))
    return torch.as_tensor(sigma * scales, dtype=_dtype(dtype), device=device)


def ht_step(x, sigma: float, sp: StepParams, lambda_3d: float = 2.7,
            color_space: str = "rgb", chunk: int = 256,
            dtype: str = "float32", engine: str = "torch", device=None):
    """HT step on an already-color-transformed LF [aH,aW,H,W,C] -> basic
    (device None: x's device for a tensor, else the CUDA card)."""
    x = torch.as_tensor(x, dtype=_dtype(dtype),
                        device=resolve_device(device, x))
    a_h, a_w, h, w, c = x.shape
    fn = _raw_step(sp, lambda_3d, a_h, a_w, h, w, c, chunk, False, dtype,
                   engine, str(x.device))
    xp = _flat_pad(x, sp.pad)
    sigma_c = _sigma_channels(sigma, color_space, c, dtype, x.device)
    num, den = fn(xp, xp, sigma_c, None)
    fb = _flat_fallback(x, sigma_c, sp, lambda_3d)
    return _finalize(num, den, sp.pad, a_h, a_w, h, w, fb)


def wiener_step(x, basic, sigma: float, sp: StepParams,
                color_space: str = "rgb", chunk: int = 256,
                dtype: str = "float32", engine: str = "torch", device=None):
    """Wiener step: BM on `basic`, shrinkage of `x` guided by `basic`
    (device as for ht_step)."""
    x = torch.as_tensor(x, dtype=_dtype(dtype),
                        device=resolve_device(device, x))
    basic = torch.as_tensor(basic, dtype=_dtype(dtype), device=x.device)
    a_h, a_w, h, w, c = x.shape
    fn = _raw_step(sp, 0.0, a_h, a_w, h, w, c, chunk, True, dtype, engine,
                   str(x.device))
    xp = _flat_pad(x, sp.pad)
    bp = _flat_pad(basic, sp.pad)
    sigma_c = _sigma_channels(sigma, color_space, c, dtype, x.device)
    mp = xp if sp.bm_source == "noisy" else bp
    num, den = fn(xp, mp, sigma_c, bp)
    fb = _flat_fallback(x, sigma_c, sp, 0.0, pilot=basic)
    return _finalize(num, den, sp.pad, a_h, a_w, h, w, fb)


@lru_cache(maxsize=None)
def build_denoise_fn(params: DenoiseParams, a_h: int, a_w: int, h: int,
                     w: int, c: int, dtype: str = "float32",
                     engine: str = "auto", device: str | None = None,
                     fused: bool | None = None, doff_mode: str = "direct"):
    """The full per-LF pipeline (color -> HT -> Wiener -> inverse color) as
    fn(lf, sigma_c) -> (basic, final) for one geometry and device (None: the
    CUDA card)."""
    dt = _dtype(dtype)
    device = resolve_device(device)
    ht_raw = _raw_step(params.ht, params.lambda_3d, a_h, a_w, h, w, c,
                       params.chunk, False, dtype, engine, str(device), fused,
                       doff_mode)
    wn_raw = _raw_step(params.wiener, 0.0, a_h, a_w, h, w, c, params.chunk,
                       True, dtype, engine, str(device), fused, doff_mode)
    use_color = c == 3 and params.color_space != "rgb"
    if use_color:
        m = np.asarray(color_matrix(params.color_space))
        mf = torch.as_tensor(m, dtype=dt, device=device)
        mi = torch.as_tensor(np.linalg.inv(m), dtype=dt, device=device)

    def fn(lf, sigma_c):
        x = lf.to(dt)
        if use_color:
            x = x @ mf.T
        xp = _flat_pad(x, params.ht.pad)
        num, den = ht_raw(xp, xp, sigma_c, None)
        fb = _flat_fallback(x, sigma_c, params.ht, params.lambda_3d)
        basic = _finalize(num, den, params.ht.pad, a_h, a_w, h, w, fb)
        xp2 = _flat_pad(x, params.wiener.pad)
        bp = _flat_pad(basic, params.wiener.pad)
        mp = xp2 if params.wiener.bm_source == "noisy" else bp
        num, den = wn_raw(xp2, mp, sigma_c, bp)
        fb = _flat_fallback(x, sigma_c, params.wiener, 0.0, pilot=basic)
        final = _finalize(num, den, params.wiener.pad, a_h, a_w, h, w, fb)
        if use_color:
            basic = basic @ mi.T
            final = final @ mi.T
        return basic, final

    return fn


def run_bm5d(noisy_lf, params: DenoiseParams, dtype: str = "float32",
             engine: str = "auto", device=None, sigma_c=None,
             fused: bool | None = None, doff_mode: str = "direct"):
    """Full two-step pipeline. noisy_lf: [aH,aW,H,W,C] RGB/gray in [0,255]
    (numpy array or tensor).

    Returns (basic, final) tensors on `device` in the input color space.
    device None: the input tensor's device, or the CUDA card for an array
    (raises without one; pass device='cpu' to run on the host). engine:
    'auto' (CUDA kernels for CUDA tensors, their plain versions on the CPU)
    or 'torch' (plain torch everywhere). sigma_c optionally overrides the
    per-channel noise stds (tensor [C]); params.sigma is then ignored.
    fused picks the route of engine 'auto' (pipeline/engine.py): None by
    shape, True the fused family (raises where no group kernel takes the
    shape), False the two-kernel path. doff_mode picks its disparity
    sampling: 'direct' (default), 'take' or 'dma' (pipeline/engine.py).
    """
    lf = torch.as_tensor(noisy_lf, dtype=_dtype(dtype),
                         device=resolve_device(device, noisy_lf))
    a_h, a_w, h, w, c = lf.shape
    fn = build_denoise_fn(params, a_h, a_w, h, w, c, dtype, engine,
                          str(lf.device), fused, doff_mode)
    if sigma_c is None:
        sigma_c = _sigma_channels(params.sigma, params.color_space, c, dtype,
                                  lf.device)
    else:
        sigma_c = torch.as_tensor(sigma_c, dtype=_dtype(dtype),
                                  device=lf.device)
    return fn(lf, sigma_c)
