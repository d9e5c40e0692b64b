#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfbm5d_torch) on one GPU.

Usage: python chip_smoke.py        (from the repository root, one CUDA card)

Phases; any failure exits non-zero without the final "ok" line:
  (a) card, versions, and the build of lfbm5d_torch/csrc/*.cu (nvcc, sm_90a);
  (b) block-matching kernels vs their plain versions at one reference SAI of
      the flagship (9x9x434x625 RGB, matched preset): mismatch fraction
      <= 1e-3 and |distance delta| <= 1 quantum;
  (c) group kernel vs its plain version on the same BM outputs, HT and
      Wiener, at 9x9x64x96 RGB and at one flagship reference: num and the
      deferred den within 1e-4 relative (L2 norm; f32 atomics order, and an
      HT coefficient within rounding of its threshold may flip);
  (d) the flagship two-step denoise through run_bm5d(engine="auto"): one warm
      run, then a timed run whose kernel launch counts must all be > 0, with
      final PSNR >= 28.37 dB and basic >= 27.64 dB; a small LF is held
      against the float64 plain pipeline on the CPU (within 0.05 dB).
Then the card's name and power limit, a {"kernels": [...]} line, and the
last line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
import traceback

PSNR_FINAL_MIN = 28.37  # recorded 28.42 dB less 0.05 dB
PSNR_BASIC_MIN = 27.64  # recorded 27.69 dB less 0.05 dB
BM_MISMATCH_MAX = 1e-3
GROUP_REL_MAX = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_bm(ctx):
    """(b) self-BM and cross-argmin kernels vs plain at one flagship ref."""
    import torch

    from lfbm5d_torch.kernels.bm import (
        cross_argmin_all_kernel, self_distances_kernel,
    )
    from lfbm5d_torch.ops.distances import cross_argmin_all, self_distances

    sp, match0, r = ctx["sp"], ctx["match0"], ctx["ref"]
    ys, xs, k, n, nd = ctx["ys"], ctx["xs"], sp.k, sp.n_search, sp.n_disp
    plane = match0[r]
    out = {}

    dk = self_distances_kernel(plane, ys, xs, k, n)
    dp = self_distances(plane, ys, xs, k, n)
    mis = float((dk != dp).float().mean())
    dmax = int((dk - dp).abs().max())
    ms = cuda_ms(lambda: self_distances_kernel(plane, ys, xs, k, n))
    pms = cuda_ms(lambda: self_distances(plane, ys, xs, k, n))
    print(f"(b) self_distances {tuple(dk.shape)}: mismatch {mis:.3e}, "
          f"max |d| {dmax} quanta; kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if mis > BM_MISMATCH_MAX or dmax > 1:
        raise AssertionError("self_distances kernel disagrees with plain")
    out["self_distances_kernel"] = dict(max_abs_err=dmax, ms=ms, plain_ms=pms)

    bk = cross_argmin_all_kernel(plane, match0, k, nd)
    bp = cross_argmin_all(plane, match0, k, nd)
    mis = float((bk != bp).float().mean())
    imax = int((bk - bp).abs().max())
    ms = cuda_ms(lambda: cross_argmin_all_kernel(plane, match0, k, nd))
    pms = cuda_ms(lambda: cross_argmin_all(plane, match0, k, nd), reps=2)
    print(f"(b) cross_argmin_all {tuple(bk.shape)}: mismatch {mis:.3e}, "
          f"max |index delta| {imax}; kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if mis > BM_MISMATCH_MAX:
        raise AssertionError("cross_argmin_all kernel disagrees with plain")
    out["cross_argmin_all_kernel"] = dict(max_abs_err=imax, ms=ms,
                                          plain_ms=pms)
    return out


def group_check(label, params, x, basic, sigma_c, wiener):
    """Group kernel vs plain at the first reference SAI of one step."""
    import torch

    from lfbm5d_torch.kernels.fused import (
        fused_group_step, fused_group_step_plain,
    )
    from lfbm5d_torch.pipeline.denoise import _flat_pad
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    sp = params.wiener if wiener else params.ht
    lam = 0.0 if wiener else params.lambda_3d
    a_h, a_w, h, w, c = x.shape
    step = build_kernel_step(sp, lam, a_h, a_w, h, w, c, wiener, "float32",
                             str(x.device))
    xp = _flat_pad(x, sp.pad)
    bp = _flat_pad(basic, sp.pad) if wiener else None
    mp = bp if wiener else xp
    noisy_pl = xp.permute(3, 0, 1, 2).contiguous()
    basic_pl = bp.permute(3, 0, 1, 2).contiguous() if wiener else None
    r = step.refs[0]
    fmask = step.flat_mask(noisy_pl, sigma_c)
    sim_y, sim_x, lvl, mask, bidx = step.block_match(
        mp[..., 0].contiguous(), r, fmask
    )
    num = torch.zeros_like(noisy_pl)
    wden = torch.zeros_like(noisy_pl)

    def run(fn):
        num.zero_()
        wden.zero_()
        fn(noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask, r, sigma_c,
           step.tables, num, wden, k=sp.k, nd=sp.n_disp, lambda_3d=lam,
           wiener=wiener)

    run(fused_group_step)
    nk, dk = num.clone(), wden.clone()
    run(fused_group_step_plain)
    rel_n = float((nk - num).norm() / num.norm())
    rel_d = float((dk - wden).norm() / wden.norm())
    err = max(float((nk - num).abs().max()), float((dk - wden).abs().max()))
    live = int(mask[:, 0].sum())
    msg = (f"(c) group {label} {'Wiener' if wiener else 'HT'}: {live}/"
           f"{mask.shape[0]} live groups, rel num {rel_n:.2e}, rel den "
           f"{rel_d:.2e}, max |d| {err:.3e}")
    ms = cuda_ms(lambda: run(fused_group_step))
    pms = cuda_ms(lambda: run(fused_group_step_plain), reps=2)
    print(msg + f"; kernel {ms:.3f} ms, plain {pms:.3f} ms")
    if not rel_n <= GROUP_REL_MAX or not rel_d <= GROUP_REL_MAX:
        raise AssertionError(f"group kernel ({label}) disagrees with plain")
    return err, ms, pms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import lfbm5d_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lfbm5d_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from lfbm5d_torch import preset_denoise_params, psnr, run_bm5d
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.kernels.bm import (
        cross_argmin_all_kernel, self_distances_kernel,
    )
    from lfbm5d_torch.kernels.fused import fused_group_step
    from lfbm5d_torch.lf import (
        add_noise_np, color_matrix, ind_initialize, synthetic_lf,
    )
    from lfbm5d_torch.pipeline.denoise import (
        _flat_pad, _sigma_channels, ht_step,
    )

    # the plain versions are the references: full-precision f32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase = "(a)"
    try:
        card = card_line()
        print(f"(a) card: {card}")
        print(f"(a) python {sys.version.split()[0]}, torch {torch.__version__}"
              f", CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        _build.library()
        nvcc_s = _build.build_seconds
        print(f"(a) kernels built and loaded in "
              f"{time.perf_counter() - t0:.1f} s (nvcc: "
              f"{'cached' if nvcc_s is None else f'{nvcc_s:.1f} s'})")

        phase = "(b)"
        params = preset_denoise_params("matched", 25.0, chunk=128)
        clean = synthetic_lf(9, 9, 434, 625, channels=3, disp_bg=1,
                             disp_fg=2, seed=0)
        noisy = add_noise_np(clean, 25.0, seed=1)
        noisy_dev = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
        clean_dev = torch.as_tensor(clean, dtype=torch.float32, device=dev)
        m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32,
                            device=dev)
        x = noisy_dev @ m.T
        sp = params.ht
        xp = _flat_pad(x, sp.pad)
        ctx = dict(
            sp=sp, match0=xp[..., 0].contiguous(), ref=0,
            ys=ind_initialize(434, sp.k, sp.p) + sp.pad,
            xs=ind_initialize(625, sp.k, sp.p) + sp.pad,
        )
        rows = phase_bm(ctx)

        phase = "(c)"
        sig = _sigma_channels(25.0, "opp", 3, "float32", dev)
        small = torch.as_tensor(
            add_noise_np(synthetic_lf(9, 9, 64, 96, channels=3, disp_bg=1,
                                      disp_fg=2, seed=0), 25.0, seed=1),
            dtype=torch.float32, device=dev,
        ) @ m.T
        small_basic = ht_step(small, 25.0, params.ht, params.lambda_3d,
                              "opp", engine="auto", device=dev)
        group_check("9x9x64x96", params, small, None, sig, False)
        group_check("9x9x64x96", params, small, small_basic, sig, True)
        pilot = clean_dev @ m.T
        e1, ms1, p1 = group_check("flagship", params, x, None, sig, False)
        e2, ms2, p2 = group_check("flagship", params, x, pilot, sig, True)
        rows["fused_group_step"] = dict(max_abs_err=max(e1, e2),
                                        ms=ms1 + ms2, plain_ms=p1 + p2)

        phase = "(d)"
        kernels = {
            "self_distances_kernel": self_distances_kernel,
            "cross_argmin_all_kernel": cross_argmin_all_kernel,
            "fused_group_step": fused_group_step,
        }
        t0 = time.perf_counter()
        basic, final = run_bm5d(noisy_dev, params, engine="auto")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        basic, final = run_bm5d(noisy_dev, params, engine="auto")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        if tuple(final.shape) != tuple(noisy.shape) or not bool(
                torch.isfinite(final).all() & torch.isfinite(basic).all()):
            raise AssertionError("flagship output has the wrong shape or "
                                 "non-finite values")
        p_noisy = psnr(noisy_dev, clean_dev)
        p_basic = psnr(basic, clean_dev)
        p_final = psnr(final, clean_dev)
        mpix = 9 * 9 * 434 * 625 / 1e6
        print(f"(d) flagship 9x9x434x625 RGB matched: warm run {warm:.3f} s, "
              f"timed run {dt:.4f} s/LF = {mpix / dt:.3f} Mpix/s")
        print(f"(d) PSNR noisy {p_noisy:.3f} / basic {p_basic:.3f} / final "
              f"{p_final:.3f} dB; launches {launches}; peak device memory "
              f"{peak / 2**30:.2f} GiB")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the path never ran: {launches}")
        if p_final < PSNR_FINAL_MIN or p_basic < PSNR_BASIC_MIN:
            raise AssertionError(f"flagship PSNR below the record: basic "
                                 f"{p_basic:.3f}, final {p_final:.3f}")

        tiny = add_noise_np(synthetic_lf(3, 3, 32, 40, channels=3, seed=8),
                            25.0, seed=9)
        tclean = synthetic_lf(3, 3, 32, 40, channels=3, seed=8)
        _, f_gpu = run_bm5d(tiny, params, engine="auto", device=dev)
        _, f_ref = run_bm5d(tiny, params, dtype="float64", engine="torch",
                            device="cpu")
        d_ps = psnr(f_gpu, tclean) - psnr(f_ref, tclean)
        d_max = float((f_gpu.cpu().double() - f_ref).abs().max())
        print(f"(d) 3x3x32x40 RGB kernels (f32, GPU) vs plain f64 (CPU): "
              f"PSNR delta {d_ps:+.4f} dB, max |d| {d_max:.3e}")
        if abs(d_ps) > 0.05:
            raise AssertionError("small LF disagrees with the f64 reference")
        if "jax" in sys.modules:
            raise AssertionError("jax was imported")
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    replaces = {
        "self_distances_kernel": ("lfbm5d_torch/csrc/bm.cu",
                                  "lfbm5d_tpu/kernels/bm.py:134"),
        "cross_argmin_all_kernel": ("lfbm5d_torch/csrc/bm.cu",
                                    "lfbm5d_tpu/kernels/bm.py:223"),
        "fused_group_step": ("lfbm5d_torch/csrc/fused.cu",
                             "lfbm5d_tpu/kernels/fused.py:433"),
    }
    out = []
    for name, (src, rep) in replaces.items():
        out.append(dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=launches[name], **rows[name]))
    print(card_line())
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
