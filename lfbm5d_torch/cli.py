"""The PyTorch port's command line: a port of `lfbm5d_tpu/cli.py`, with the
same subcommands, flags, positional forms and JSON report.

  denoise:  load LF -> [add AWGN if clean + sigma given] -> two-step HT+Wiener
            -> PSNR/RMSE report -> write basic / denoised / diff LFs
            (the basic LF on disk doubles as the between-steps checkpoint).
  sr:       load LR LF -> bicubic x-scale init -> [filter + back-projection]
            loop -> write HR LF; per-iteration checkpoints.

It runs on the CUDA card unless `--device cpu` is given (and raises without
a card). `--engine` takes the reference's names: `pallas` runs the port's
kernels (`auto`), `pallas_bf16` the kernels with the bfloat16 chain
(`auto_bf16`), `xla` its plain torch engine (`torch`). `--preset
adaptive-region` runs the region composite
(pipeline/adaptive.py::denoise_region_adaptive).

Usage examples:
  python -m lfbm5d_torch.cli denoise --input noisy_dir \\
      --pattern 'SAI_%02d_%02d.png' --awidth 9 --aheight 9 --sigma 25 \\
      --output out_dir --basic basic_dir
  python -m lfbm5d_torch.cli sr --input lr_dir --pattern 'SAI_%02d_%02d.png' \\
      --awidth 9 --aheight 9 --scale 2 --output hr_dir
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lfbm5d_torch import config as _config
from lfbm5d_torch.config import DenoiseParams, SRParams, StepParams
from lfbm5d_torch.lf.io import fetch_rounded, load_lf, save_lf
from lfbm5d_torch.lf.metrics import psnr_device, psnr_grid_device
from lfbm5d_torch.lf.noise import add_noise_np

# the reference CLI's engine names -> the port's engines
_ENGINES = {"auto": "auto", "pallas": "auto", "xla": "torch",
            "torch": "torch", "pallas_bf16": "auto_bf16",
            "auto_bf16": "auto_bf16"}


def _engine(name: str) -> str:
    return _ENGINES[name]


def _step_args(ap: argparse.ArgumentParser, prefix: str, tau_default: float):
    # All step flags default to None sentinels so an explicitly passed value
    # always wins over the preset, even when it equals the documented default
    # (merge order: explicit flag > preset > documented default).
    g = ap.add_argument_group(f"{prefix} step parameters")
    g.add_argument(f"--{prefix}-nsim", type=int, default=None,
                   help="max similar patches N (power of two; default 16)")
    g.add_argument(f"--{prefix}-nsearch", type=int, default=None,
                   help="self-similarity search half-window n (default 16)")
    g.add_argument(f"--{prefix}-ndisp", type=int, default=None,
                   help="angular/disparity search half-window nDisp "
                   "(default 2)")
    g.add_argument(f"--{prefix}-k", type=int, default=None,
                   help="patch size k (default 8)")
    g.add_argument(f"--{prefix}-p", type=int, default=None,
                   help="reference-patch step p (default 3)")
    g.add_argument(f"--{prefix}-pang", type=int, default=None,
                   help="reference-SAI grid step (default 1 = every SAI "
                   "serves as reference, the reference semantics; >1 "
                   "subsamples the reference role, ~p_ang^2 less work)")
    g.add_argument(f"--{prefix}-tau2d", default=None,
                   choices=["dct", "bior"], help="default dct")
    g.add_argument(f"--{prefix}-tau4d", default=None,
                   choices=["dct", "id"], help="default dct")
    g.add_argument(f"--{prefix}-tau5d", default=None,
                   choices=["haar", "hadamard", "dct"], help="default haar")
    g.add_argument(f"--{prefix}-taumatch", type=float, default=None,
                   help=f"BM threshold (default {tau_default:g})")
    g.add_argument(f"--{prefix}-usesd", action="store_true", default=None)
    g.add_argument(f"--{prefix}-flattau", type=float, default=None,
                   help="flat-region fallback threshold (default 0 = off; "
                   "reference patches with channel-0 variance <= "
                   "flattau*sigma^2 skip the 5D pipeline, uncovered pixels "
                   "take the angular-mean 2D fallback)")


# Flag-name view of the canonical presets (config.PRESETS is the single
# source of truth; BASELINE.md knee sweeps are the measurement record).
# 'adaptive' (denoise mode only) probes the LF's angular redundancy and
# picks 'matched' or 'robust' per content (pipeline/adaptive.py).
_FIELD_TO_FLAG = {"n_sim": "nsim", "n_search": "nsearch", "n_disp": "ndisp",
                  "p": "p", "p_ang": "pang", "k": "k", "flat_tau": "flattau"}
_PRESETS = {
    name: {_FIELD_TO_FLAG[f]: v for f, v in over.items()}
    for name, over in _config.PRESETS.items()
}

_STEP_DEFAULTS = dict(
    nsim=16, nsearch=16, ndisp=2, k=8, p=3, pang=1, tau2d="dct", tau4d="dct",
    tau5d="haar", usesd=False, flattau=0.0,
)


def _step_params(ns, prefix: str, tau_default: float) -> StepParams:
    over = _PRESETS[ns.preset]

    def g(name):
        val = getattr(ns, f"{prefix}_{name}")
        if val is not None:
            return val  # explicit flag wins
        if name in over:
            return over[name]  # then the preset
        return _STEP_DEFAULTS.get(name, tau_default)  # documented default

    return StepParams(
        n_sim=g("nsim"), n_search=g("nsearch"), n_disp=g("ndisp"),
        k=g("k"), p=g("p"), p_ang=g("pang"), tau_2d=g("tau2d"),
        tau_4d=g("tau4d"), tau_5d=g("tau5d"), tau_match=g("taumatch"),
        use_sd=g("usesd"), flat_tau=g("flattau"),
    )


def _common_io_args(ap):
    ap.add_argument("--input", required=True, help="input LF directory")
    ap.add_argument("--pattern", default="SAI_%02d_%02d.png",
                    help="printf-style SAI name pattern with two indices")
    ap.add_argument("--aheight", type=int, required=True)
    ap.add_argument("--awidth", type=int, required=True)
    ap.add_argument("--s-offset", type=int, default=0,
                    help="first vertical angular index on disk")
    ap.add_argument("--t-offset", type=int, default=0)
    ap.add_argument("--bit-depth", type=int, default=8, choices=[8, 16])
    ap.add_argument("--color-space", default="opp",
                    choices=["opp", "yuv", "ycbcr", "rgb"])
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "pallas_bf16", "auto_bf16",
                             "xla", "torch"],
                    help="auto / pallas: the CUDA kernels (their plain "
                    "versions on the CPU); auto_bf16 / pallas_bf16: the "
                    "same with the group stage's transform chain in "
                    "bfloat16 (grids of at most 128 SAIs; f32 beyond); "
                    "xla / torch: plain torch")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card; 'cpu' "
                    "runs on the host)")
    ap.add_argument("--preset", default="default",
                    choices=sorted(_PRESETS) + ["adaptive", "adaptive-region"],
                    help="parameter preset; explicit per-step flags "
                    "override. 'adaptive' (denoise only) probes the LF's "
                    "angular redundancy and picks 'matched' or 'robust' "
                    "per content (BASELINE.md content-robustness tables); "
                    "'adaptive-region' additionally localizes the robust "
                    "pass to a crop of the static region and composites it "
                    "over a full-frame matched pass (pipeline/adaptive.py)")
    ap.add_argument("--json", action="store_true",
                    help="emit a structured JSON report on stdout")


def _log(ns, payload: dict):
    if ns.json:
        print(json.dumps(payload))
    else:
        for k, v in payload.items():
            print(f"{k}: {v}")


def cmd_denoise(ns) -> int:
    from lfbm5d_torch.device import resolve_device
    from lfbm5d_torch.pipeline.denoise import run_bm5d
    from lfbm5d_torch.utils.timing import StageTimer, device_fence

    engine = _engine(ns.engine)
    device = resolve_device(ns.device)
    timer = StageTimer()
    try:
        with timer.stage("load"):
            lf = load_lf(ns.input, ns.pattern, ns.aheight, ns.awidth,
                         ns.s_offset, ns.t_offset)
    except (FileNotFoundError, IOError) as e:
        print(f"error: cannot load light field from {ns.input!r}: {e}",
              file=sys.stderr)
        return 2
    clean = None
    if ns.sigma_add is not None:
        clean = lf
        with timer.stage("add_noise"):
            lf = add_noise_np(clean, ns.sigma_add, seed=ns.seed)
    sigma = ns.sigma if ns.sigma is not None else ns.sigma_add
    if sigma is None:
        print("error: provide --sigma (noise level) and/or --sigma-add",
              file=sys.stderr)
        return 2

    def build_params(preset_name: str) -> DenoiseParams:
        # route every path through the same merge machinery so explicit
        # per-step flags and the globals (--lam/--color-space/--chunk)
        # override the preset uniformly, adaptive modes included
        saved, ns.preset = ns.preset, preset_name
        try:
            return DenoiseParams(
                sigma=sigma, lambda_3d=ns.lam, color_space=ns.color_space,
                ht=_step_params(ns, "ht", 2500.0),
                wiener=_step_params(ns, "wien", 400.0),
                chunk=ns.chunk,
            )
        finally:
            ns.preset = saved

    probe_stats = None
    region_info = None
    if ns.preset == "adaptive":
        from lfbm5d_torch.pipeline.adaptive import select_preset

        ns.preset, probe_stats = select_preset(lf, sigma)
    if ns.preset == "adaptive-region":
        from lfbm5d_torch.pipeline.adaptive import denoise_region_adaptive

        with timer.stage("denoise"):
            basic, final, region_info = denoise_region_adaptive(
                lf, sigma, engine=engine, device=device,
                params_matched=build_params("matched"),
                params_robust=build_params("robust"))
            device_fence(final)
        probe_stats = region_info["stats"]
        ns.preset = f"region:{region_info['mode']}"
    else:
        params = build_params(ns.preset)
        with timer.stage("denoise"):
            basic, final = run_bm5d(lf, params, engine=engine, device=device)
            device_fence(final)

    with timer.stage("save"):
        # fetch_rounded quantises on the device, so the copy to the host
        # moves uint8 (or 16-bit) values; the metrics below reduce on the
        # device
        if ns.basic:
            save_lf(fetch_rounded(basic, ns.bit_depth), ns.basic, ns.pattern,
                    ns.s_offset, ns.t_offset, ns.bit_depth)
        save_lf(fetch_rounded(final, ns.bit_depth), ns.output, ns.pattern,
                ns.s_offset, ns.t_offset, ns.bit_depth)
        if ns.diff:
            diff = torch.clamp(
                final - torch.as_tensor(lf, dtype=final.dtype,
                                        device=final.device) + 128.0,
                0, 255)
            save_lf(fetch_rounded(diff, ns.bit_depth), ns.diff, ns.pattern,
                    ns.s_offset, ns.t_offset, ns.bit_depth)

    mpix = lf.shape[0] * lf.shape[1] * lf.shape[2] * lf.shape[3] / 1e6
    report = {
        "mode": "denoise", "shape": list(lf.shape), "sigma": sigma,
        **(
            {"preset_selected": ns.preset,
             "static_fraction": round(probe_stats["static_fraction"], 3)}
            if probe_stats is not None else {}
        ),
        **(
            {"region_box": list(region_info["box"]),
             "region_area_frac": region_info["area_frac"]}
            if region_info is not None and "box" in region_info else {}
        ),
        "mpix": round(mpix, 3),
        "seconds_denoise": round(timer.seconds("denoise"), 3),
        "mpix_per_s": round(mpix / max(timer.seconds("denoise"), 1e-9), 3),
        **{f"seconds_{k}": round(v, 3) for k, v in timer.items()},
    }
    if clean is not None:
        report["psnr_noisy_db"] = round(
            psnr_device(torch.as_tensor(lf), clean), 3)
        p_basic = psnr_device(basic, clean)
        p_final = psnr_device(final, clean)
        report["psnr_basic_db"] = round(p_basic, 3)
        report["psnr_final_db"] = round(p_final, 3)
        # exact inverse of the PSNR definition (psnr = 20 log10(255/rmse))
        report["rmse_final"] = round(
            0.0 if p_final == float("inf")
            else 255.0 * 10.0 ** (-p_final / 20.0), 4)
        if ns.per_sai_psnr:
            grid = psnr_grid_device(final, clean)
            report["psnr_per_sai_db"] = [
                [round(float(v), 2) for v in row] for row in grid
            ]
    _log(ns, report)
    return 0


def cmd_sr(ns) -> int:
    from lfbm5d_torch.device import resolve_device
    from lfbm5d_torch.pipeline.sr import run_sr
    from lfbm5d_torch.utils.timing import StageTimer, device_fence

    if ns.preset in ("adaptive", "adaptive-region"):
        print(f"error: --preset {ns.preset} is denoise-only (the probe's "
              "decision tables are measured for the denoising presets)",
              file=sys.stderr)
        return 2
    engine = _engine(ns.engine)
    device = resolve_device(ns.device)
    timer = StageTimer()
    try:
        with timer.stage("load"):
            lf = load_lf(ns.input, ns.pattern, ns.aheight, ns.awidth,
                         ns.s_offset, ns.t_offset)
    except (FileNotFoundError, IOError) as e:
        print(f"error: cannot load light field from {ns.input!r}: {e}",
              file=sys.stderr)
        return 2
    # unset schedule knobs take the preset's measured schedule
    # (config.SR_SCHEDULES; explicit flags always win)
    from lfbm5d_torch.config import SR_SCHEDULES

    sched = SR_SCHEDULES.get(ns.preset, SR_SCHEDULES["default"])
    n_iter = ns.n_iter if ns.n_iter is not None else sched["n_iter"]
    sigma_init = (ns.sigma_init if ns.sigma_init is not None
                  else sched["sigma_init"])
    ns.n_iter, ns.sigma_init = n_iter, sigma_init  # for the JSON report
    params = SRParams(
        scale=ns.scale, n_iter=n_iter, sigma_init=sigma_init,
        sigma_final=ns.sigma_final, color_space=ns.color_space,
        lambda_3d=ns.lam, ht=_step_params(ns, "ht", 2500.0),
        wiener=_step_params(ns, "wien", 400.0), bp_gain=ns.bp_gain,
        decimation_blur=ns.decimation_blur, chunk=ns.chunk,
    )

    def checkpoint(i, hr):
        if ns.checkpoint:
            save_lf(fetch_rounded(hr, ns.bit_depth),
                    f"{ns.checkpoint}/iter_{i:02d}",
                    ns.pattern, ns.s_offset, ns.t_offset, ns.bit_depth)

    with timer.stage("sr"):
        hr = run_sr(lf, params, on_iteration=checkpoint, engine=engine,
                    device=device)
        device_fence(hr)
    hr = fetch_rounded(hr, ns.bit_depth)
    with timer.stage("save"):
        save_lf(hr, ns.output, ns.pattern, ns.s_offset, ns.t_offset,
                ns.bit_depth)
    _log(ns, {
        "mode": "sr", "scale": ns.scale, "n_iter": ns.n_iter,
        "shape_out": list(hr.shape),
        **{f"seconds_{k}": round(v, 3) for k, v in timer.items()},
    })
    return 0


# Reference-style positional contract (SURVEY.md §2.9: one positional-arg CLI,
# ~30 args; the mount was empty all rounds, so the ORDER below is this
# project's documented reconstruction of the IPOL-lineage convention — the
# parameter vocabulary and semantics are the firm part of the spec):
#
#   lfbm5d denoise INPUT_DIR PATTERN AWIDTH AHEIGHT S_OFF T_OFF SIGMA
#       ADD_NOISE(0|1) LAMBDA
#       N_HARD N_SEARCH_HARD NDISP_HARD K_HARD P_HARD TAU2D_HARD USESD_HARD
#       TAU4D_HARD TAU5D_HARD
#       N_WIEN N_SEARCH_WIEN NDISP_WIEN K_WIEN P_WIEN TAU2D_WIEN USESD_WIEN
#       TAU4D_WIEN TAU5D_WIEN
#       COLOR_SPACE OUTPUT_DIR BASIC_DIR|none DIFF_DIR|none [NB_THREADS]
#
# ADD_NOISE=1 treats the input as clean, synthesizes AWGN of std SIGMA and
# reports PSNR (the reference's experiment mode, SURVEY.md §2.9 "Noise").
# NB_THREADS (the reference's OpenMP knob) is accepted for contract parity
# and ignored: the card owns its parallelism.
_POSITIONAL_DENOISE = 31

# The reference SR branch ships its own positional main (SURVEY.md §2
# component 11, §2.9); same reconstruction stance as the denoise block —
# the parameter vocabulary is the firm part of the spec, the order is this
# project's documented convention:
#
#   lfbm5d sr INPUT_DIR PATTERN AWIDTH AHEIGHT S_OFF T_OFF
#       SCALE N_ITER SIGMA_INIT SIGMA_FINAL BP_GAIN LAMBDA
#       N_HARD N_SEARCH_HARD NDISP_HARD K_HARD P_HARD TAU2D_HARD USESD_HARD
#       TAU4D_HARD TAU5D_HARD
#       N_WIEN N_SEARCH_WIEN NDISP_WIEN K_WIEN P_WIEN TAU2D_WIEN USESD_WIEN
#       TAU4D_WIEN TAU5D_WIEN
#       COLOR_SPACE OUTPUT_DIR CHECKPOINT_DIR|none [NB_THREADS]
_POSITIONAL_SR = 33


def _positional_to_flags(rest: list[str]) -> list[str]:
    """Translate the reference-style positional block to the flagged form."""
    if len(rest) == _POSITIONAL_DENOISE + 1:
        rest = rest[:-1]  # trailing NB_THREADS: parsed, advisory only
    if len(rest) != _POSITIONAL_DENOISE:
        raise SystemExit(
            f"error: positional denoise form takes "
            f"{_POSITIONAL_DENOISE} (+ optional NB_THREADS) arguments, "
            f"got {len(rest)} (see the module docstring for the order)"
        )
    (inp, pattern, aw, ah, soff, toff, sigma, addn, lam,
     nh, nsh, ndh, kh, ph, t2h, sdh, t4h, t5h,
     nw, nsw, ndw, kw, pw, t2w, sdw, t4w, t5w,
     cs, outd, basicd, diffd) = rest
    args = [
        "denoise", "--input", inp, "--pattern", pattern,
        "--awidth", aw, "--aheight", ah, "--s-offset", soff,
        "--t-offset", toff, "--sigma", sigma, "--lam", lam,
        "--color-space", cs, "--output", outd,
        "--ht-nsim", nh, "--ht-nsearch", nsh, "--ht-ndisp", ndh,
        "--ht-k", kh, "--ht-p", ph, "--ht-tau2d", t2h,
        "--ht-tau4d", t4h, "--ht-tau5d", t5h,
        "--wien-nsim", nw, "--wien-nsearch", nsw, "--wien-ndisp", ndw,
        "--wien-k", kw, "--wien-p", pw, "--wien-tau2d", t2w,
        "--wien-tau4d", t4w, "--wien-tau5d", t5w,
    ]
    if int(addn):
        args += ["--sigma-add", sigma]
    if int(sdh):
        args += ["--ht-usesd"]
    if int(sdw):
        args += ["--wien-usesd"]
    if basicd.lower() != "none":
        args += ["--basic", basicd]
    if diffd.lower() != "none":
        args += ["--diff", diffd]
    return args


def _positional_sr_to_flags(rest: list[str]) -> list[str]:
    """Translate the reference-style SR positional block to the flagged form."""
    if len(rest) == _POSITIONAL_SR + 1:
        rest = rest[:-1]  # trailing NB_THREADS: parsed, advisory only
    if len(rest) != _POSITIONAL_SR:
        raise SystemExit(
            f"error: positional sr form takes {_POSITIONAL_SR} (+ optional "
            f"NB_THREADS) arguments, got {len(rest)} (see the comment above "
            "_POSITIONAL_SR for the order)"
        )
    (inp, pattern, aw, ah, soff, toff, scale, n_iter, s_init, s_final,
     bp_gain, lam,
     nh, nsh, ndh, kh, ph, t2h, sdh, t4h, t5h,
     nw, nsw, ndw, kw, pw, t2w, sdw, t4w, t5w,
     cs, outd, ckptd) = rest
    args = [
        "sr", "--input", inp, "--pattern", pattern,
        "--awidth", aw, "--aheight", ah, "--s-offset", soff,
        "--t-offset", toff, "--scale", scale, "--n-iter", n_iter,
        "--sigma-init", s_init, "--sigma-final", s_final,
        "--bp-gain", bp_gain, "--lam", lam,
        "--color-space", cs, "--output", outd,
        "--ht-nsim", nh, "--ht-nsearch", nsh, "--ht-ndisp", ndh,
        "--ht-k", kh, "--ht-p", ph, "--ht-tau2d", t2h,
        "--ht-tau4d", t4h, "--ht-tau5d", t5h,
        "--wien-nsim", nw, "--wien-nsearch", nsw, "--wien-ndisp", ndw,
        "--wien-k", kw, "--wien-p", pw, "--wien-tau2d", t2w,
        "--wien-tau4d", t4w, "--wien-tau5d", t5w,
    ]
    if int(sdh):
        args += ["--ht-usesd"]
    if int(sdw):
        args += ["--wien-usesd"]
    if ckptd.lower() != "none":
        args += ["--checkpoint", ckptd]
    return args


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # reference-style positional blocks: `lfbm5d denoise <31 positionals>` /
    # `lfbm5d sr <33 positionals>`, optionally followed by flags of the
    # flagged form (e.g. --device cpu, --json)
    if (len(argv) >= 2 and argv[0] in ("denoise", "sr")
            and not argv[1].startswith("-")):
        n = next((i for i, a in enumerate(argv) if a.startswith("--")),
                 len(argv))
        shim = (_positional_to_flags if argv[0] == "denoise"
                else _positional_sr_to_flags)
        argv = shim(list(argv[1:n])) + list(argv[n:])
    ap = argparse.ArgumentParser(
        prog="lfbm5d", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    dn = sub.add_parser("denoise", help="two-step HT+Wiener denoising")
    _common_io_args(dn)
    dn.add_argument("--sigma", type=float, default=None,
                    help="noise std on the [0,255] scale")
    dn.add_argument("--sigma-add", type=float, default=None,
                    help="treat input as clean: add AWGN of this std first "
                    "and report PSNR against the clean input")
    dn.add_argument("--seed", type=int, default=0, help="AWGN seed")
    dn.add_argument("--lam", type=float, default=2.7,
                    help="hard-threshold multiplier lambda")
    dn.add_argument("--chunk", type=int, default=128)
    dn.add_argument("--output", required=True, help="denoised LF directory")
    dn.add_argument("--basic", default=None,
                    help="basic (post-HT) LF directory — the between-steps "
                    "checkpoint")
    dn.add_argument("--diff", default=None, help="difference LF directory")
    dn.add_argument("--per-sai-psnr", action="store_true",
                    help="include the per-SAI PSNR grid in the report")
    _step_args(dn, "ht", 2500.0)
    _step_args(dn, "wien", 400.0)
    dn.set_defaults(fn=cmd_denoise)

    sr = sub.add_parser("sr", help="super-resolution (x2/x3/x4)")
    _common_io_args(sr)
    sr.add_argument("--scale", type=int, default=2, choices=[2, 3, 4])
    sr.add_argument("--n-iter", type=int, default=None,
                    help="IBP iterations (default: the --preset's schedule, "
                    "config.SR_SCHEDULES; reference-style 'default' = 10)")
    sr.add_argument("--sigma-init", type=float, default=None,
                    help="sigma schedule start (default: the --preset's "
                    "schedule; 'default' = 12, 'matched' = 8 — the measured "
                    "knee, BASELINE.md round-5 SR table)")
    sr.add_argument("--sigma-final", type=float, default=1.0)
    sr.add_argument("--bp-gain", type=float, default=1.0)
    sr.add_argument("--decimation-blur", type=float, default=0.0,
                    help="Gaussian pre-blur std of the IBP decimation model "
                    "(0 = plain box average)")
    sr.add_argument("--lam", type=float, default=2.7)
    sr.add_argument("--chunk", type=int, default=128)
    sr.add_argument("--output", required=True, help="HR LF directory")
    sr.add_argument("--checkpoint", default=None,
                    help="directory for per-iteration HR checkpoints")
    _step_args(sr, "ht", 2500.0)
    _step_args(sr, "wien", 400.0)
    sr.set_defaults(fn=cmd_sr)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
