"""The port's measuring entry point: a port of the reference's `bench.py`,
flag for flag, on the CUDA card.

    python -m lfbm5d_torch.bench [--full | --proxy | --quick]
        [--preset default|fast|matched|robust|adaptive|adaptive-region]
        [--runs N] [--engine auto|pallas|pallas_bf16|xla|torch|auto_bf16]
        [--sigma S] [--family F] [--profile DIR] [--device DEV]

Prints ONE JSON line as its last line of standard output: the reference's
keys (`metric`, `value` in Mpix/s, `unit`, `vs_baseline`,
`vs_baseline_ref`, `seconds_per_lf`, `run_seconds`, `spread_frac`,
`compile_plus_first_s`, `mpix`, `psnr_{noisy,basic,final}_db`, `preset`,
`family`, `shape`, `quick`, and `adaptive_selected` on the adaptive rows),
plus `engine` (the port's engine name) and `device` (`name`, `count`,
`power_limit`; on the host `{"name": "cpu", ...}`).

The default is the headline: a 9x9x434x625 RGB synthetic LF (two planes at
disparities 1 and 2, synth seed 0), sigma 25 AWGN (noise seed 1), two-step
HT + Wiener in OPP at the `matched` preset. `--proxy` (5x5x192x256) and
`--quick` (3x3x96x128) default to the `fast` preset. `--family` picks the
content families of the reference's bench; `--preset adaptive` runs the
host probe (`select_preset` on the host copy of the noisy LF) inside the
timed loop, `adaptive-region` the region composite
(`pipeline/adaptive.py::denoise_region_adaptive`). `--engine` takes the
reference's names, mapped as the CLI maps them (`pallas` -> `auto`, `xla`
-> `torch`, `pallas_bf16` -> `auto_bf16`).

Protocol: the noisy LF is moved to the device as float32 before anything
is timed. The first run is never counted: on the card it builds the CUDA
kernels at first use (`kernels/_build.py`; about 80-100 s of nvcc in a
fresh checkout, nothing when `build/kernels/<hash>/` already holds them),
so `compile_plus_first_s` includes that build, as the reference's
includes XLA's compile. Then `--runs` timed runs (default 3), each ended
by `torch.cuda.synchronize()` on the host's `time.perf_counter()`;
`seconds_per_lf` is their minimum, `value` = mpix / minimum, `spread_frac`
= (max - min) / min. TF32 is off during the runs, so the two-kernel
route's GEMMs and the SR resize einsums stay full float32. `--profile DIR`
runs torch.profiler over the timed runs (their times then include the
profiler's cost), writes a Chrome trace to DIR and prints the 12 ops with
the most device self time to stderr.

Numbers are printed unrounded (the reference rounds them). `vs_baseline`
is null in every row: no H100 baseline is recorded yet. It
runs on the CUDA card and raises without one unless `--device cpu` is
given (the tests' tiny shapes).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from lfbm5d_torch.cli import _ENGINES
from lfbm5d_torch.config import preset_denoise_params
from lfbm5d_torch.device import resolve_device
from lfbm5d_torch.lf.metrics import psnr, psnr_device
from lfbm5d_torch.lf.noise import add_noise_np
from lfbm5d_torch.lf.synth import synthetic_lf, synthetic_lf_multi
from lfbm5d_torch.pipeline.adaptive import (
    denoise_region_adaptive,
    select_preset,
)
from lfbm5d_torch.pipeline.denoise import run_bm5d

# (aH, aW, H, W) of each configuration and the label of its metric
SHAPES = {"full": (9, 9, 434, 625), "proxy": (5, 5, 192, 256),
          "quick": (3, 3, 96, 128)}
TAGS = {"full": "9x9 EPFL-scale headline config",
        "proxy": "rounds-1/2 continuity proxy for the 9x9 headline",
        "quick": "quick smoke config"}
PRESET_CHOICES = ("default", "fast", "matched", "robust", "adaptive",
                  "adaptive-region")
# content family -> (generator, kwargs after aH, aW, H, W, channels=3):
# the reference bench's families, synth seed 0
FAMILIES = {
    "two-plane": (synthetic_lf, dict(disp_bg=1, disp_fg=2, seed=0)),
    "low-disp": (synthetic_lf, dict(disp_bg=0, disp_fg=1, seed=0)),
    "occl3": (synthetic_lf_multi, dict(disps=(0.5, 1.5, 3.0), seed=0,
                                       blob_frac=0.3)),
    "occl-grad": (synthetic_lf_multi, dict(disps=(0.5, 1.5, 3.0), seed=0,
                                           blob_frac=0.3, texture_grad=0.7)),
    "static-min": (synthetic_lf, dict(disp_bg=0, disp_fg=2, seed=0)),
    "static-flat": (synthetic_lf_multi, dict(disps=(0.0, 2.0), seed=0,
                                             blob_frac=0.25, flat_frac=0.4)),
}
PROFILE_TOP = 12


def parse(argv) -> argparse.Namespace:
    """The reference bench's flags, plus --device. Returns the namespace
    with `shape` (aH, aW, H, W) set by --quick / --proxy (else the
    headline's), `preset` defaulted per shape and `engine` mapped to the
    port's name."""
    ap = argparse.ArgumentParser(
        prog="python -m lfbm5d_torch.bench",
        description="Time the two-step LFBM5D denoiser on a synthetic LF; "
        "print one JSON line.")
    ap.add_argument("--full", action="store_true",
                    help="(the default) headline config: 9x9 x 434x625 RGB "
                    "at the matched preset")
    ap.add_argument("--proxy", action="store_true",
                    help="continuity config: 5x5 x 192x256 at the fast "
                    "preset (unless --preset overrides)")
    ap.add_argument("--quick", action="store_true",
                    help="small LF (3x3x96x128) smoke test")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs after the untimed first run")
    ap.add_argument("--preset", default=None, choices=PRESET_CHOICES,
                    help="'default' = reference-default parameters; 'fast' "
                    "= throughput preset; 'matched' = the headline default; "
                    "'robust' = within 0.05 dB of default on every tested "
                    "content class; 'adaptive' = the host content probe "
                    "picks matched/robust per LF inside the timed loop; "
                    "'adaptive-region' = the probe plus the region "
                    "composite")
    ap.add_argument("--engine", default="auto", choices=list(_ENGINES),
                    help="the reference's names (pallas -> auto, xla -> "
                    "torch, pallas_bf16 -> auto_bf16) or the port's")
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--family", default="two-plane", choices=list(FAMILIES),
                    help="synthetic LF content family; 'occl-grad' is the "
                    "weak-texture class the adaptive router sends to robust")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the timed "
                    "runs to DIR and print the top ops to stderr")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                    "the kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    if args.runs < 1:
        ap.error("--runs must be at least 1")
    config = "quick" if args.quick else "proxy" if args.proxy else "full"
    args.shape = SHAPES[config]
    if args.preset is None:
        args.preset = "matched" if config == "full" else "fast"
    args.engine = _ENGINES[args.engine]
    return args


def bench_inputs(a_h: int, a_w: int, h: int, w: int, family: str,
                 sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) host arrays [aH, aW, H, W, 3]: the family's LF and
    AWGN of std sigma, noise seed 1."""
    gen, kw = FAMILIES[family]
    clean = gen(a_h, a_w, h, w, 3, **kw)
    return clean, add_noise_np(clean, sigma, seed=1)


def device_info(dev: torch.device) -> dict:
    """name, count and power limit of the card (nvidia-smi's
    `power.limit`); on the host {"name": "cpu", "count": 1,
    "power_limit": None}."""
    if dev.type != "cuda":
        return {"name": "cpu", "count": 1, "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return {"name": torch.cuda.get_device_name(index),
            "count": torch.cuda.device_count(),
            "power_limit": line.rsplit(",", 1)[-1].strip()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def print_top(prof, dev: torch.device) -> None:
    """The PROFILE_TOP ops with the most self time on the device (the
    host's for a CPU run) of a finished torch.profiler run, to stderr."""
    cuda = dev.type == "cuda"
    rows = []
    for ev in prof.key_averages():
        if cuda:
            t = ev.self_device_time_total
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
        else:
            t = ev.self_cpu_time_total
        if t > 0:
            rows.append((t / 1e6, ev.count, ev.key))
    rows.sort(key=lambda r: -r[0])
    print(f"{'device' if cuda else 'host'} self-time total: "
          f"{sum(r[0] for r in rows):.4f}s", file=sys.stderr)
    for sec, count, key in rows[:PROFILE_TOP]:
        print(f"{sec:9.4f}s {count:9d}x {key[:80]}", file=sys.stderr)


def measure(noisy, clean, *, preset: str, sigma: float, engine: str,
            runs: int, device, family: str = "two-plane",
            profile: str | None = None) -> dict:
    """One bench row: an untimed first run, then `runs` timed runs of the
    two-step denoiser on `noisy` (host array [aH, aW, H, W, C]) at
    `preset`, scored against `clean`. engine: the reference's or the
    port's name. Returns the row's JSON-ready dict."""
    engine = _ENGINES[engine]
    dev = resolve_device(device)
    a_h, a_w, h, w, c = np.shape(noisy)
    config = next((k for k, s in SHAPES.items() if s == (a_h, a_w, h, w)),
                  None)
    adaptive = preset in ("adaptive", "adaptive-region")
    info = device_info(dev)
    print(f"device: {info}", file=sys.stderr)

    noisy_dev = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
    _sync(dev)

    if preset == "adaptive-region":
        def run_once():
            basic, final, out = denoise_region_adaptive(noisy_dev, sigma,
                                                        engine=engine)
            return out["mode"], (basic, final)
    elif preset == "adaptive":
        # the probe reads the host copy, as a driver holding the LF would
        def run_once():
            name, _ = select_preset(noisy, sigma)
            params = preset_denoise_params(name, sigma, chunk=128)
            return name, run_bm5d(noisy_dev, params, engine=engine)
    else:
        params = preset_denoise_params(preset, sigma, chunk=128)

        def run_once():
            return preset, run_bm5d(noisy_dev, params, engine=engine)

    # full-precision float32 GEMMs and einsums for every timed run
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        selected, (basic, final) = run_once()
        _sync(dev)
        compile_and_first = time.perf_counter() - t0
        print(f"compile+first run: {compile_and_first:.1f}s", file=sys.stderr)
        if adaptive:
            print(f"adaptive probe selected: {selected}", file=sys.stderr)

        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        times = []
        with (torch.profiler.profile(activities=acts) if profile
              else contextlib.nullcontext()) as prof:
            for _ in range(runs):
                t0 = time.perf_counter()
                selected, (basic, final) = run_once()
                _sync(dev)
                times.append(time.perf_counter() - t0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if profile:
        os.makedirs(profile, exist_ok=True)
        path = os.path.join(profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}", file=sys.stderr)
        print_top(prof, dev)

    dt = min(times)
    mpix = a_h * a_w * h * w / 1e6
    tag = TAGS[config] if config else "shape set by the caller"
    fam_tag = "" if family == "two-plane" else f" family={family},"
    result = {
        "metric": (
            f"Mpix/s denoised, two-step HT+Wiener, "
            f"{a_h}x{a_w}x{h}x{w} RGB synthetic LF,{fam_tag} "
            f"sigma={sigma:g}, preset={preset} ({tag})"
        ),
        "value": mpix / dt,
        "unit": "Mpix/s",
        "vs_baseline": None,
        "vs_baseline_ref": "no H100 baseline recorded yet",
        "seconds_per_lf": dt,
        "run_seconds": times,
        "spread_frac": (max(times) - dt) / dt,
        "compile_plus_first_s": compile_and_first,
        "mpix": mpix,
        "psnr_noisy_db": psnr(np.clip(noisy, 0, 255), clean),
        "psnr_basic_db": psnr_device(basic, clean),
        "psnr_final_db": psnr_device(final, clean),
        "preset": preset,
        "family": family,
        "shape": [a_h, a_w, h, w, c],
        "quick": config == "quick",
        "engine": engine,
        "device": info,
    }
    if adaptive:
        result["adaptive_selected"] = selected
    return result


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)  # raises here without a card
    t0 = time.perf_counter()
    clean, noisy = bench_inputs(*args.shape, args.family, args.sigma)
    print(f"synth LF {clean.shape} in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    result = measure(noisy, clean, preset=args.preset, sigma=args.sigma,
                     engine=args.engine, runs=args.runs, device=dev,
                     family=args.family, profile=args.profile)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
