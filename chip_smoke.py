#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfbm5d_torch) on one GPU.

Usage (from the repository root, one CUDA card):

    python chip_smoke.py                    the phases below
    python chip_smoke.py --ab PARENT        the kernels of a parent checkout
        (PARENT, its lfbm5d_torch/csrc built apart) against this tree's, in
        turns: the two BM kernels at (b)'s four shapes (outputs equal); both
        group kernels (lfbm5d_group_step at the flagship's reference 0,
        lfbm5d_group_step_banked at 9x9x64x96 `default`), f32 and bf16
        chains, HT and Wiener, on the same BM outputs (bf16 outputs within
        1e-3 relative L2 of each other, f32 within 1e-4), with the times,
        HT + Wiener per chain and new/parent; extract / fused accumulate at
        (e)'s table shape (extract equal, accumulate within 1e-5), and the
        row gather at (j)'s flagship shape (outputs equal, index_select
        beside them; see `ab`), and both trees' nvcc seconds per source
    python chip_smoke.py --swap-check       whether (q) sees an s/t swap that
        every square check passes: mutant group kernels (the f32 slice
        decoded transposed, in a copy of lfbm5d_torch/csrc built in a
        temporary directory; the bf16 dense table built for the swapped
        order, in memory) against their plain versions at square and
        non-square grids (see `swap_check`)
    python chip_smoke.py --profile [CELLS]  where the device time goes: each
        cell of CELLS (comma-separated names; all by default) once to warm
        up, then once under torch.profiler: wall time, device busy time,
        the device's idle share and device time by kernel group (cells
        `flagship-dma`: the flagship with doff_mode="dma"; `sr-flagship`:
        the x2 SR of phase (l)); the cell `counters` builds the group
        kernels with per-phase clock64 counters (-DLFBM5D_PHASE_CLOCKS,
        build/kernels_clocks/) and prints each chain's cycles per (group,
        channel) step by phase at the flagship's reference 0 and 9x9x64x96
        `default`, HT and Wiener (`phase_clocks`)

Phases; any failure exits non-zero without the final "ok" line:
  (a) card, versions, and the build of lfbm5d_torch/csrc/*.cu (nvcc, sm_90a;
      seconds per source, the group kernels' with both chains): ptxas
      registers and spill per kernel (the BM kernels at k=8, and a summary
      of k=1..16; the group kernels as <f32> and <bf16, tiles> for the
      bf16 chain's eight tile counts), failing if a bf16 group kernel
      spills; the launch plan
      of every group-kernel shape the phases launch (the bf16
      instantiations' at 9x9 and at (q)'s grids) (cluster size, threads,
      shared bytes per CTA, max active
      clusters, CTAs per SM), the Python copy (kernels/fused.py::group_plan)
      equal to the library's; the BM plans (kernels/bm.py::bm_plan,
      self_plan) equal to the library's at every BM shape the phases launch
      ((q)'s non-square ones included);
      the extract/accumulate plan (kernels/extract.py::twokernel_plan) equal
      to the library's at every two-kernel shape the phases launch; the row
      gather's plan (kernels/gather.py::gather_plan) equal to the library's
      at every gather shape the phases launch;
  (b) block-matching kernels vs their plain versions at reference SAI 0,
      exactly equal (mismatch 0), with kernel ms, plain ms and the bound, at
      four shapes: the flagship (9x9x434x625 RGB) as `matched` (n=16, nd=1,
      p=8), `default` (nd=2, pad 18, p=3, T=29601) and `fast` (n=8, nd=2,
      p=6), and 17x17x128x128 `matched` (A=289);
  (c) group kernel vs its plain version on the same BM outputs, HT and
      Wiener, at 9x9x64x96 RGB and at one flagship reference: num and the
      deferred den within 1e-4 relative (L2 norm; f32 atomics order, and an
      HT coefficient within rounding of its threshold may flip); each
      group check prints its launch plan (as in (a));
  (d) the flagship two-step denoise through run_bm5d(engine="auto") (route
      "fused"): one warm run, then a timed run whose kernel launch counts
      must all be > 0, with final PSNR >= 28.37 dB and basic >= 27.64 dB; a
      small LF is held against the float64 plain pipeline on the CPU (within
      0.05 dB);
  (e) the kernels of the 17x17 and N=16 paths vs their plain versions:
      Python group_smem_bytes == the library's; the banked group kernel,
      HT and Wiener, within 1e-4 relative at 17x17x32x32 RGB matched,
      9x9x64x96 RGB `default` (N=16), 17x17x32x32 and 19x19x32x32
      `default` (the clusters of 16) and
      17x17x128x128; extract_groups exact and the two accumulate forms
      within 1e-5 relative at one 17x17x128x128 reference (timed: the
      kernels line's rows), at the first engine chunk of a 17x17x512x512
      reference, at k in {4, 12, 16} with nd in {0, 2} (A = 289 and 400),
      with SAI tiles (k=16 at 33x33), at A = 1, with a doff table and on an
      all-masked chunk; the edge shapes no other phase launches, each kernel
      vs plain: the group kernel at an A = 1 cluster plan and with N = 1
      groups, the BM kernels at nd = 0; with a second card, one extract and
      one group check on cuda:1 while cuda:0 is current;
  (f) 17x17x128x128 RGB matched (synth seed 0, disp 1/2, noise seed 100,
      sigma 25: the config-5 probe content) through engine="auto" (route
      "banked") and fused=False (route "two_kernel"): final PSNR >= 27.907
      dB on both (the recorded 27.957 less 0.05), within 0.05 dB of each
      other, and every kernel of each route launched;
  (g) 17x17x512x512 RGB matched (the HCI benchmark's view size), one timed
      run after (f) warmed the kernels: s/LF, Mpix/s, PSNR, peak memory;
  (h) the `default` and `robust` presets at 9x9x24x32 RGB through
      engine="auto" on the card (route "banked"), each within 0.05 dB of the
      float64 plain pipeline (engine="torch"; run on the card, where it
      takes seconds instead of minutes on the host's CPU);
  (i) the `default` and `robust` presets at the flagship's full size
      (9x9x434x625 RGB, noise seed 1), one timed run each through
      engine="auto" (route "banked"): s/LF, Mpix/s, PSNR and peak memory;
      final PSNR >= the reference's record less 0.05 dB (default 28.416,
      robust 28.552) and s/LF under a ceiling that keeps the script inside
      its time limit;
  (j) gather_rows exactly equal to its plain version at the flagship's
      `dma` shape (the [V0*V1, 81] int32 table of reference SAI 0's argmin
      maps, gathered at its T*N slots), at 17x17x128x128's (W = 289) and at
      ragged shapes (float32, W = 1 and 7, S = 1, S not a multiple of the
      plan's tile); at the flagship the kernel and index_select in turns
      over 21 rounds, each on a cold L2 with the host's submission kept out
      of the timed window (`cuda_ms_cold`: median, min, max), and each
      function's host time per call over 300 calls; the plain version's
      time;
  (k) the flagship matched denoise with doff_mode "take" and "dma" (one
      warm run, then one timed run each, then (d)'s "direct" again): final
      PSNR within 0.01 dB of (d)'s and >= 28.37 dB; the "dma" run launches
      gather_rows and the group kernel;
  (l) x2 SR of the flagship: the clean 9x9x434x624 two-plane LF (synth
      seed 0, disp 1/2) box-decimated to 9x9x217x312, run_sr with the
      `matched` schedule (5 iterations, sigma 8 -> 1) on engine="auto": HR
      PSNR >= 31.549 dB (the reference's record 31.599 less 0.05) and >=
      bicubic + 1.5 dB; s/LF, HR Mpix/s, peak memory; a 3x3x32x40 SR on the
      card within 0.05 dB of the float64 plain SR (engine="torch");
  (m) the content router: select_preset on the flagship's noisy two-plane
      LF (a CUDA tensor: the corner-SAI fetch) selects `matched`;
      adaptive_denoise_params on the occl-grad family (bench.py's
      definition, 9x9x434x625, noise seed 1) selects `robust`, and its one
      timed run_bm5d reaches final PSNR >= 29.83 dB (the reference's record
      29.88 less 0.05);
  (n) denoise_batch over three flagship LFs (9x9x434x625 RGB, matched,
      noise seeds 1-3; a batch tensor on cuda:0, LF i on card i % count):
      s/LF, peak memory; each final PSNR >= 28.37 dB and within 0.01 dB of
      run_bm5d on the same LF;
  (o) the same three LFs written as PNG SAIs under build/, streamed disk to
      disk by stream_denoise_dirs (decode ahead, encode behind): s/LF,
      seconds_device / seconds_total, the codec that ran; the PNGs read
      back reach final PSNR >= 28.37 dB; then `python -m lfbm5d_torch.cli
      denoise --preset matched --json` on the first of them in a
      subprocess, its PNGs >= 28.37 dB. Where no PNG codec exists, one line
      names what is missing and the disk part does not run;
  (p) the bfloat16 transform chain (engine "auto_bf16", the reference's
      `pallas_bf16`): the bf16 group kernels against their bf16 plain
      versions on the same BM outputs, HT and Wiener, num and deferred den
      within 1e-3 relative L2 (measured up to 1.6e-4 on an H100: kernel and
      plain version add in different orders, the tensor cores' sums too, so
      a value within f32 rounding of a bf16 rounding boundary may round the
      other way, and HT threshold flips amplify it), at (c)'s 9x9x64x96 RGB
      matched and one flagship reference (route fused) and at 9x9x64x96
      `default` (N=16, route banked), with kernel ms, plain ms and the
      bound beside the f32 kernel's ms on the same reference, timed in
      turns (f32, bf16, bf16, f32), and untimed at the tile counts and
      grids no other phase launches (8x8 matched and `default`: even sides;
      1x1 at flat_tau 0, 5x5, 6x6, 10x10 and 11x11: A = 1, 25, 36, 100 and
      121, tile counts 1, 2, 3, 7 and 8); the
      flagship 9x9x434x625 matched
      through run_bm5d(engine="auto_bf16"), one warm and one timed run:
      s/LF, Mpix/s, peak memory, final PSNR >= 28.37 dB and within 0.02 dB
      of (d)'s f32 final, basic >= 27.64 dB, the bf16 group kernel launched
      and the f32 one not. The chain costs PSNR in the reference too: its
      bf16-rounded angular DCT tables scale the mean by 1.0039 (the 9x9 DC
      entry 1/9 rounds 0.195% high, forward and inverse), and its
      pallas_bf16 loses 0.013 dB against its f32 at 9x9x32x48
      (tests/test_torch_bf16.py); whether the 0.01 dB record that admits
      bf16 into the default chain (ROADMAP, trap 4) is met is printed; `default` and `robust` at 9x9x24x32 through
      auto_bf16 (route banked, bf16 kernel launched), each within 0.05 dB
      of (h)'s float64 plain pipeline; 17x17x32x32 matched through
      auto_bf16 (289 SAIs, beyond the chain's 128): the same step as auto
      (route banked, f32 kernel launched, no bf16 one), final within 1e-4
      relative L2 of auto's;
  (q) non-square angular grids (aH != aW: with one angular transform on
      both axes, kron(F, F) commutes with swapping s and t, so an s/t swap
      passes every square check): the two-plane LF (synth seed 0, disp 1/2,
      noise seed 1, sigma 25, RGB) at 32x48, reference SAI (1, 3) clipped
      to the grid (s != t); self-BM and cross-argmin exactly equal
      (mismatch 0) at 5x7 and 7x5 `matched`; the route's f32 group kernel
      within 1e-4 relative L2 (as (c)) and, at A <= 128, its bf16 one
      within 1e-3 (as (p)), HT and Wiener, at 5x7 and 7x5 `matched` and
      5x7 `default` (route fused, bf16 tile count 3), 1x9 and 9x1 `matched`
      (fused, one tile), 8x16 and 16x8 `matched` (banked, A = 128, tile
      count 8) and 13x19 `matched` (banked f32, A = 247); extract_groups
      exact and both accumulate forms within 1e-5 (as (e)) at 5x7 with a
      doff table (doff_mode "take"); then run_bm5d at 5x7x64x96 RGB
      `matched` through engine "auto" (route fused), "auto_bf16" (fused
      bf16) and fused=False (two_kernel), and at 16x8x32x32 through "auto"
      (banked): each final PSNR within 0.05 dB of the float64 plain
      pipeline (engine "torch") run on the card, its route's kernels
      launched and no other group kernel;
  (r) the bench, `python -m lfbm5d_torch.bench` (its `main`, in process,
      stdout captured): the headline (no flags: 9x9x434x625 `matched`, one
      untimed and three timed runs) prints the reference's keys plus
      `engine` and `device` (the card's name), vs_baseline null, final
      PSNR >= 28.37 and basic >= 27.64 dB, self-BM, cross-argmin and the
      f32 group kernel launched 18 times per run over the four runs, and
      seconds_per_lf at most 1.5 times (d)'s timed run (both printed);
      `--quick` and `--proxy`: the keys and finite PSNRs; `--preset
      adaptive`: the router picks `matched`; `--engine pallas_bf16 --runs
      1`: the bf16 group kernel launched and the f32 one not; then `python
      -m lfbm5d_torch.bench --quick --profile DIR` in a subprocess (the
      build of (a) reused) exits 0 with a JSON last line naming the card,
      a Chrome trace in DIR and its top ops by device time on stderr.
Then the card's name and power limit, a {"kernels": [...]} line (launches
from the path each kernel serves; ms and plain_ms at that path's shapes,
the BM rows at the matched flagship; the bf16 rows' launches from (p)'s
flagship and `default` runs, their ms at (p)'s flagship reference and
9x9x64x96 `default` reference;
bound_ms the larger of the bytes over 3.35 TB/s and the fp32 operations over
67 TFLOP/s that this run's inputs need, and for the bf16 rows of their
angular contractions over the 989 TFLOP/s of the bf16 tensor cores), and
the last line
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

PSNR_FINAL_MIN = 28.37  # recorded 28.42 dB less 0.05 dB
PSNR_BASIC_MIN = 27.64  # recorded 27.69 dB less 0.05 dB
PSNR_17_MIN = 27.907  # recorded 27.957 dB (17x17x128x128 matched) less 0.05
# flagship LF, final PSNR: recorded 28.416 dB (default) and 28.552 dB
# (robust: default + 0.136) less 0.05 dB; s/LF ceilings guard the time limit
PRESET_MIN = {"default": (28.366, 240.0), "robust": (28.502, 90.0)}
GROUP_REL_MAX = 1e-4
GROUP_BF16_REL_MAX = 1e-3  # (p): bf16 kernels vs bf16 plain (docstring)
BF16_PSNR_DELTA_MAX = 0.02  # (p): auto_bf16 vs (d)'s f32 final, dB
TRAP4_PSNR_DELTA = 0.01  # the record that admits bf16 to the default chain
A_GT_128_REL_MAX = 1e-4  # (p): auto_bf16 vs auto at 17x17, final
ACC_REL_MAX = 1e-5
PSNR_DELTA_MAX = 0.05
DOFF_PSNR_DELTA_MAX = 0.01  # (k): take/dma vs direct, final PSNR
SR_PSNR_MIN = 31.549  # recorded 31.599 dB (flagship x2 SR, matched) less 0.05
SR_OVER_BICUBIC_MIN = 1.5  # dB; bicubic recorded 29.853 dB
ROUTED_PSNR_MIN = 29.83  # recorded 29.88 dB (occl-grad, routed) less 0.05
BATCH_NOISE_SEEDS = (1, 2, 3)  # (n), (o): three flagship LFs
BATCH_PSNR_DELTA_MAX = 0.01  # (n): batch vs run_bm5d on the same LF, dB
BENCH_DT_RATIO_MAX = 1.5  # (r): the bench's headline s/LF over (d)'s
# (r): every key of the reference bench's JSON line, and the port's two
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "vs_baseline_ref",
              "seconds_per_lf", "run_seconds", "spread_frac",
              "compile_plus_first_s", "mpix", "psnr_noisy_db",
              "psnr_basic_db", "psnr_final_db", "preset", "family", "shape",
              "quick", "engine", "device")
REPO = os.path.dirname(os.path.abspath(__file__))
GATHER_ROUNDS = 21  # (j), --ab: alternating cold-L2 rounds per function
GATHER_HOST_CALLS = 300  # (j): calls timed back to back on the host's clock
# cold-L2 windows: the spin queued before the start event (device clock
# cycles, about 1 ms at the H100's clocks), which must outlast the host's
# submission of the start event and the timed call
SLEEP_CYCLES = 2_000_000
# (j) ragged gathers: (V, W, S, dtype name), each exact against plain
GATHER_RAGGED = ((1000, 7, 1031, "float32"), (1000, 1, 1, "float32"),
                 (500, 1, 4099, "int32"), (300, 7, 1, "int32"),
                 (300, 289, 13, "float32"))
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak

# name -> (angular side, H, W, noise seed, preset, fused, doff_mode) of the
# synthetic two-plane LF (synth seed 0, disp 1/2, sigma 25, RGB) the phases
# run; noise seed None: x2 SR of the clean LF box-decimated by 2
CELLS = {
    "flagship": (9, 434, 625, 1, "matched", None, "direct"),
    "17-banked": (17, 128, 128, 100, "matched", None, "direct"),
    "17-two-kernel": (17, 128, 128, 100, "matched", False, "direct"),
    "17-512": (17, 512, 512, 100, "matched", None, "direct"),
    "17-512-two-kernel": (17, 512, 512, 100, "matched", False, "direct"),
    "flagship-default": (9, 434, 625, 1, "default", None, "direct"),
    "flagship-robust": (9, 434, 625, 1, "robust", None, "direct"),
    "flagship-dma": (9, 434, 625, 1, "matched", None, "dma"),
    "sr-flagship": (9, 434, 624, None, "matched", None, "direct"),
}
# occl-grad: bench.py's weak-texture family (3 occluding planes, a 0.7
# texture-contrast ramp), the content the router sends to `robust`
OCCL_GRAD = dict(disps=(0.5, 1.5, 3.0), seed=0, blob_frac=0.3,
                 texture_grad=0.7)
# kernel-name fragment -> group of the profile, first match wins
KERNEL_GROUPS = (
    ("gather_rows", "row gather (gather.cu)"),
    ("banked_kernel", "group kernel, banked (fused_banked.cu)"),
    ("group_kernel", "group kernel (fused.cu)"),
    ("extract_kernel", "extract (twokernel.cu)"),
    ("accumulate_kernel", "accumulate (twokernel.cu)"),
    ("cross_argmin", "cross-argmin (bm.cu)"),
    ("self_distances", "self-BM (bm.cu)"),
    ("gemm", "cuBLAS GEMMs"),
    ("sort", "argsort (select_similar)"),
)

# (q): the grids (aH, aW, preset) whose group kernels are held against their
# plain versions at NONSQUARE_HW (each route's f32 kernel, and its bf16 one
# where A <= 128); BM at the 35-SAI matched grids, the two-kernel route at
# the first; then run_bm5d end to end per (aH, aW, H, W, (engine, fused,
# the kernel that run must launch)), against the float64 plain pipeline
NONSQUARE = ((5, 7, "matched"), (7, 5, "matched"), (5, 7, "default"),
             (1, 9, "matched"), (9, 1, "matched"), (8, 16, "matched"),
             (16, 8, "matched"), (13, 19, "matched"))
NONSQUARE_HW = (32, 48)
NONSQUARE_RUNS = (
    (5, 7, 64, 96, (("auto", None, "fused_group_step"),
                    ("auto_bf16", None, "fused_group_step_bf16"),
                    ("auto", False, "extract_groups"))),
    (16, 8, 32, 32, (("auto", None, "fused_group_step_banked"),)))
GROUP_KERNELS = ("fused_group_step", "fused_group_step_banked",
                 "fused_group_step_bf16", "fused_group_step_banked_bf16")

PHASE_NAMES = ("angular tables to shared", "scatter (loads, spatial fwd, "
               "DSMEM stores)", "angular forward", "stack and shrink",
               "block_sum", "angular inverse", "cluster barriers (waiting)",
               "fetch, spatial inverse, atomics", "rest (prologue, origins, "
               "weights)")
# (label, preset, angular side, H, W, banked): the group-kernel cells of
# `--profile counters` and `--ab`
CLOCK_CASES = (("flagship reference 0", "matched", 9, 434, 625, False),
               ("9x9x64x96 default", "default", 9, 64, 96, True))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def ptxas_lines(log: str):
    """'kernel: registers; spills' per kernel from ptxas' -v report; a
    kernel instantiated per k is named kernel<k>, and per k and a flag
    (the accumulate kernel's den) kernel<k, true|false>; the group kernels'
    chains kernel<f32|bf16>."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '\w*\d([a-z_]+_kernel)"
                      r"(?:ILi(\d+)E(?:Lb([01])E)?|ILb([01])E(?:Li(\d+)E)?)?",
                      line)
        if m:
            name = m.group(1) + (
                f"<{'bf16' if m.group(4) == '1' else 'f32'}"
                f"{f', {m.group(5)}' if m.group(5) not in (None, '0') else ''}>"
                if m.group(4) is not None else
                "" if m.group(2) is None else f"<{m.group(2)}>"
                if m.group(3) is None else
                f"<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>")
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line and name:
            yield f"{name}: {line.split(':', 1)[-1].strip()}; {spill}"
            name = None


def print_ptxas(log: str, tag: str) -> None:
    """The report of every kernel; of the per-k BM kernels, k=8 (every
    preset's) and a summary of the others."""
    per_k = {}
    for line in ptxas_lines(log):
        m = re.match(r"(\w+)<(\d+)(, \w+)?>: .*?(\d+) registers.*?(\d+) "
                     r"bytes spill stores", line)
        if m:
            per_k.setdefault((m.group(1), m.group(3) or ""), []).append(
                (int(m.group(2)), int(m.group(4)), int(m.group(5))))
            if m.group(2) != "8":
                continue
        print(f"{tag} ptxas {line}")
    for (name, flag), rows in per_k.items():
        regs = [r for _, r, _ in rows]
        spilled = [k for k, _, sp in sorted(rows) if sp]
        print(f"{tag} ptxas {name}<1..16{flag}>: {len(rows)} instantiations, "
              f"{min(regs)}-{max(regs)} registers, spill stores at k="
              f"{spilled or 'none'}")


def check_bf16_spills(log: str, tag: str) -> None:
    """Fails unless ptxas reports every bf16 group-kernel instantiation (one
    per tile count 1..8, of each kernel) with 0 bytes of spill stores and
    loads; prints registers and spills per kernel."""
    found = {}
    for line in ptxas_lines(log):
        name = line.split(":", 1)[0]
        kern = name.split("<", 1)[0]
        if kern in ("group_kernel", "banked_kernel") and "<bf16" in name:
            m = re.search(r"(\d+) registers.*?(\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            found.setdefault(kern, []).append(
                (name, *map(int, m.groups())) if m else (name, -1, -1, -1))
    for kern in ("group_kernel", "banked_kernel"):
        rows = found.get(kern, [])
        print(f"{tag} bf16 spills: {kern}: " + "; ".join(
            f"{n[len(kern):]} {r} registers, {st} / {ld} B spill stores / "
            f"loads" for n, r, st, ld in rows))
        if len(rows) != 8:
            raise AssertionError(f"{tag}: ptxas reported {len(rows)} bf16 "
                                 f"instantiations of {kern}, not 8")
        if any(st or ld for _, _, st, ld in rows):
            raise AssertionError(f"{tag}: a bf16 {kern} spills")


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


_SPIN_MS = []  # device ms of one torch.cuda._sleep(SLEEP_CYCLES)


def spin_ms() -> float:
    """Device time of the spin that cuda_ms_cold queues (measured once)."""
    import torch

    if not _SPIN_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)  # first call: clocks up
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        torch.cuda.synchronize()
        _SPIN_MS.append(start.elapsed_time(end))
    return _SPIN_MS[0]


def cuda_ms_cold(fn, reps: int = 5) -> float:
    """Mean device time of fn with the L2 flushed before each launch (a
    128 MB write between the timed intervals). A spin (torch.cuda._sleep)
    queued after the flush and before the start event keeps the device busy
    while the host records the start event and submits fn, so the window
    holds device work only, not the host's path to the launch; raises if
    that submission outlasted the spin."""
    import torch

    flush = torch.empty(1 << 25, dtype=torch.float32, device="cuda:0")
    cover = spin_ms()
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host >= cover:
            raise AssertionError(f"cuda_ms_cold: host submission {host:.3f} "
                                 f"ms outlasted the {cover:.3f} ms spin")
        total += start.elapsed_time(end)
    return total / reps


def host_us(fn, calls: int = GATHER_HOST_CALLS) -> float:
    """Host time per call of fn, over `calls` calls with no synchronisation
    between them (the device catches up after the clock stops)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def cold_rounds(fns, rounds: int = GATHER_ROUNDS):
    """Each of fns once per round on a cold L2 (cuda_ms_cold), the order
    rotating from round to round: (median, min, max) ms per function."""
    times = [[] for _ in fns]
    for i in range(rounds):
        for j in range(len(fns)):
            j = (j + i) % len(fns)
            times[j].append(cuda_ms_cold(fns[j], reps=1))
    return [(statistics.median(t), min(t), max(t)) for t in times]


def lf_on_card(a, h, w, noise_seed, dev="cuda:0", a_w=None):
    """(noisy, clean) f32 on the card: the two-plane LF of CELLS, a x a
    SAIs (a x a_w when a_w is given)."""
    import torch

    from lfbm5d_torch.lf import add_noise_np, synthetic_lf

    clean = synthetic_lf(a, a if a_w is None else a_w, h, w, channels=3,
                         disp_bg=1, disp_fg=2, seed=0)
    noisy = add_noise_np(clean, 25.0, seed=noise_seed)
    return (torch.as_tensor(noisy, dtype=torch.float32, device=dev),
            torch.as_tensor(clean, dtype=torch.float32, device=dev))


def timed_run(lf, params, **kw):
    """run_bm5d ended by a synchronize: ((basic, final), seconds)."""
    import torch

    from lfbm5d_torch import run_bm5d

    t0 = time.perf_counter()
    out = run_bm5d(lf, params, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sr_flagship(a, h, w):
    """(lr, clean, SRParams): the clean two-plane LF on the card, box-
    decimated x2, and the `matched` SR schedule over the matched preset."""
    import torch

    from lfbm5d_torch import SR_SCHEDULES, SRParams, preset_denoise_params
    from lfbm5d_torch.lf import synthetic_lf
    from lfbm5d_torch.lf.resize import downsample

    clean = torch.as_tensor(
        synthetic_lf(a, a, h, w, channels=3, disp_bg=1, disp_fg=2, seed=0),
        dtype=torch.float32, device="cuda:0")
    dn = preset_denoise_params("matched", 25.0, chunk=128)
    params = SRParams(scale=2, sigma_final=1.0, ht=dn.ht, wiener=dn.wiener,
                      chunk=dn.chunk, **SR_SCHEDULES["matched"])
    return downsample(clean, 2), clean, params


def timed_sr(lr, params, **kw):
    """run_sr ended by a synchronize: (hr, seconds)."""
    import torch

    from lfbm5d_torch import run_sr

    t0 = time.perf_counter()
    hr = run_sr(lr, params, **kw)
    torch.cuda.synchronize()
    return hr, time.perf_counter() - t0


def bound(nbytes: float, flops: float, tc_flops: float = 0.0):
    """(bound_ms, bound_by): the least time for these bytes, fp32
    operations and bf16 tensor-core operations on an H100 SXM (the units
    run side by side: the largest of the three times)."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = max(flops / FP32_FLOPS, tc_flops / BF16_TC_FLOPS) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bm_cases(x_flag, x17):
    """(b)'s four BM shapes, [(label, ctx)]: reference SAI 0 of the
    flagship (OPP planes x_flag) padded and gridded as the `matched`,
    `default` and `fast` presets, and of 17x17x128x128 (x17) as `matched`
    (A = 289)."""
    from lfbm5d_torch import preset_denoise_params

    return [(label, bm_ctx(preset_denoise_params(preset, 25.0).ht, x))
            for label, preset, x in (
                ("flagship matched", "matched", x_flag),
                ("flagship default", "default", x_flag),
                ("flagship fast", "fast", x_flag),
                ("17x17x128x128 matched", "matched", x17))]


def bm_ctx(sp, x, ref=0):
    """The BM inputs of step params sp at reference SAI `ref` of the OPP LF
    x: the padded matching planes and the reference grid."""
    from lfbm5d_torch.lf import ind_initialize
    from lfbm5d_torch.pipeline.denoise import _flat_pad

    h, w = x.shape[2:4]
    return dict(sp=sp, match0=_flat_pad(x, sp.pad)[..., 0].contiguous(),
                ref=ref, ys=ind_initialize(h, sp.k, sp.p) + sp.pad,
                xs=ind_initialize(w, sp.k, sp.p) + sp.pad)


def bm_bounds(ctx, dk, bk):
    """((bytes, fp32 operations) of self-BM, (bytes, operations) of
    cross-argmin) at one BM shape."""
    sp, match0 = ctx["sp"], ctx["match0"]
    k, nd = sp.k, sp.n_disp
    a, hp, wp = match0.shape
    self_w = (nbytes(match0[ctx["ref"]], dk), dk.numel() * k * k * 3)
    # per displacement: squared differences, vertical and horizontal k-taps
    v0, v1 = bk.shape[1:]
    ops = a * (2 * nd + 1) ** 2 * (3 * hp * wp + (k - 1) * (v0 * wp + v0 * v1))
    return self_w, (nbytes(match0[ctx["ref"]], match0, bk), ops)


def phase_bm(label, ctx):
    """Self-BM and cross-argmin kernels vs plain at one reference SAI:
    exactly equal; kernel ms, plain ms and the bound."""
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
    bk = cross_argmin_all_kernel(plane, match0, k, nd)
    bp = cross_argmin_all(plane, match0, k, nd)
    self_w, cross_w = bm_bounds(ctx, dk, bk)
    for name, got, want, kern, plain, work, preps in (
            ("self_distances_kernel", dk, dp,
             lambda: self_distances_kernel(plane, ys, xs, k, n),
             lambda: self_distances(plane, ys, xs, k, n), self_w, 5),
            ("cross_argmin_all_kernel", bk, bp,
             lambda: cross_argmin_all_kernel(plane, match0, k, nd),
             lambda: cross_argmin_all(plane, match0, k, nd), cross_w, 2)):
        mis = int((got != want).sum())
        ms = cuda_ms(kern)
        pms = cuda_ms(plain, reps=preps)
        bms, by = bound(*work)
        print(f"{label} {name} {tuple(got.shape)} (k={k}, n={n}, nd={nd}): "
              f"mismatch {mis}; kernel {ms:.4f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.4f} ms ({by}; bytes {bound(work[0], 0)[0]:.4f}, "
              f"operations {bound(0, work[1])[0]:.4f}), kernel/bound "
              f"{ms / bms:.2f}")
        if mis or not torch.equal(got, want):
            raise AssertionError(f"{name} ({label}) disagrees with plain")
        out[name] = dict(max_abs_err=0, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by)
    return out


def bm_plan_table(lib) -> None:
    """(a): the cross-argmin plan (tile, chunk, grid, shared bytes) and the
    self-BM plan (threads, window pitch, runs) of every BM shape the phases
    launch, Python copies (kernels/bm.py::bm_plan, self_plan) == library;
    the flagship's printed."""
    import ctypes

    from lfbm5d_torch import preset_denoise_params
    from lfbm5d_torch.kernels._build import check
    from lfbm5d_torch.kernels.bm import bm_plan, self_plan
    from lfbm5d_torch.lf import ind_initialize

    lfs = ((9, 434, 625), (9, 434, 624), (17, 128, 128), (17, 512, 512),
           (9, 24, 32), (9, 64, 96), (3, 32, 40), (17, 32, 32), (19, 32, 32),
           (20, 32, 32), (33, 24, 24), (1, 64, 64))
    # (A, H, W): the square LFs above, then (q)'s non-square ones
    shapes = [(side * side, h, w) for side, h, w in lfs] + [
        (a_h * a_w, *NONSQUARE_HW) for a_h, a_w, _ in NONSQUARE] + [
        (a_h * a_w, h, w) for a_h, a_w, h, w, _ in NONSQUARE_RUNS]
    steps = [(preset, preset_denoise_params(preset, 25.0).ht)
             for preset in ("matched", "default", "robust", "fast")]
    steps.append(("matched nd=0", steps[0][1].replace(n_disp=0)))
    seen = set()
    for preset, sp in steps:
        for a, h, w in shapes:
            key = (h + 2 * sp.pad, w + 2 * sp.pad, a, sp.k, sp.n_disp)
            if key in seen:
                continue
            seen.add(key)
            out = (ctypes.c_int * 5)()
            check(lib.lfbm5d_bm_plan(*key, out), "lfbm5d_bm_plan")
            if tuple(out) != bm_plan(*key):
                raise AssertionError(f"bm_plan{key}: library {tuple(out)} "
                                     f"vs Python {bm_plan(*key)}")
            t = (len(ind_initialize(h, sp.k, sp.p))
                 * len(ind_initialize(w, sp.k, sp.p)))
            sout = (ctypes.c_int * 3)()
            check(lib.lfbm5d_self_plan(sp.k, sp.n_search, t, sout),
                  "lfbm5d_self_plan")
            py = self_plan(sp.k, sp.n_search, t)
            if tuple(sout) != py:
                raise AssertionError(f"self_plan({sp.k}, {sp.n_search}, {t}): "
                                     f"library {tuple(sout)} vs Python {py}")
            if (a, h, w) == (81, 434, 625):
                print(f"(a) bm_plan {preset} flagship (hp, wp, A, k, nd) "
                      f"{key}: tile {out[0]}x{out[1]}, SAI chunk {out[2]}, "
                      f"grid {out[3]}, {out[4]} B shared; self-BM T={t}: "
                      f"{sout[0]} threads, window pitch {sout[1]}")
    print(f"(a) bm_plan, self_plan: Python copy == library at {len(seen)} "
          f"shapes")


# (k, A) of every two-kernel launch of the phases: 17x17 matched, then
# two_kernel_shapes', second_card's and (q)'s 5x7
TWO_KERNEL_SHAPES = ((8, 289), (4, 400), (12, 289), (16, 289), (16, 400),
                     (16, 1089), (8, 1), (8, 81), (8, 35))


def twokernel_plan_table(lib) -> None:
    """(a): the extract/accumulate plan (patch rows per chunk, SAIs per tile,
    stage pitch, shared bytes) at every two-kernel shape the phases launch,
    Python copy (kernels/extract.py::twokernel_plan) == library."""
    import ctypes

    from lfbm5d_torch.kernels._build import check
    from lfbm5d_torch.kernels.extract import twokernel_plan

    for k, a in TWO_KERNEL_SHAPES:
        out = (ctypes.c_int * 4)()
        check(lib.lfbm5d_twokernel_plan(k, a, out), "lfbm5d_twokernel_plan")
        if tuple(out) != twokernel_plan(k, a):
            raise AssertionError(f"twokernel_plan({k}, {a}): library "
                                 f"{tuple(out)} vs Python "
                                 f"{twokernel_plan(k, a)}")
        print(f"(a) twokernel_plan k={k}, A={a}: {out[0]} patch rows per "
              f"chunk, {out[1]} SAIs per tile, pitch {out[2]}, {out[3]} B "
              f"shared")


def gather_shapes(params):
    """(S, W) of every gather_rows launch of the phases: the `dma` slot rows
    of one reference SAI (T reference patches x N slots, W = A) at the
    flagship (9x9x434x625) and at 17x17x128x128, then GATHER_RAGGED's."""
    from lfbm5d_torch.lf.pad import ind_initialize

    sp = params.ht
    out = []
    for a, h, w in ((9, 434, 625), (17, 128, 128)):
        t = len(ind_initialize(h, sp.k, sp.p)) * len(
            ind_initialize(w, sp.k, sp.p))
        out.append((t * sp.n_sim, a * a))
    return out + [(n, w) for _, w, n, _ in GATHER_RAGGED]


def gather_plan_table(lib, params) -> None:
    """(a): the row gather's plan (slots per block, threads, grid) at every
    shape the phases launch, Python copy (kernels/gather.py::gather_plan)
    == library."""
    import ctypes

    from lfbm5d_torch.kernels._build import check
    from lfbm5d_torch.kernels.gather import gather_plan

    for n, w in gather_shapes(params):
        out = (ctypes.c_int * 3)()
        check(lib.lfbm5d_gather_plan(n, w, out), "lfbm5d_gather_plan")
        if tuple(out) != gather_plan(n, w):
            raise AssertionError(f"gather_plan({n}, {w}): library "
                                 f"{tuple(out)} vs Python "
                                 f"{gather_plan(n, w)}")
        print(f"(a) gather_plan S={n}, W={w}: {out[0]} slots per block, "
              f"{out[1]} threads, grid {out[2]}")


def group_flops(lvl, mask, c, a_h, a_w, wiener, dense=False):
    """(fp32 operations, bf16 tensor-core operations) of the group stage
    for this run's live groups: per plane and live group of ns = 2**lvl
    slots, a transform is np*2048 (spatial) + 128*np*(aH+aW) (angular) +
    128*A*ns^2 (stack) with np = ns*A patches; HT runs two transforms,
    Wiener three; aggregation is 128*np more. The bf16 chain's angular
    transform is the dense 128*np*A on the tensor cores instead."""
    import torch

    a = a_h * a_w
    live = mask.any(dim=1)
    ns = (1 << lvl.long())[live].double()
    npch = ns * a
    n_tr = 3 if wiener else 2
    angular = n_tr * 128 * npch * (a if dense else a_h + a_w)
    fp32 = n_tr * (npch * 2048 + 128 * a * ns * ns) + 128 * npch
    if not dense:
        fp32 = fp32 + angular
    tc = angular if dense else torch.zeros_like(angular)
    return float(torch.sum(fp32)) * c, float(torch.sum(tc)) * c


def group_setup(params, x, basic, sigma_c, wiener, chain=None, ref=None):
    """The group stage's inputs at the first reference SAI of one step (or
    at SAI `ref`; its tables in the transform chain `chain`), and run(f,
    **kw): zero num/wden, then call a group function f on them."""
    import torch

    from lfbm5d_torch.pipeline.denoise import _flat_pad
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    sp = params.wiener if wiener else params.ht
    lam = 0.0 if wiener else params.lambda_3d
    a_h, a_w, h, w, c = x.shape
    step = build_kernel_step(sp, lam, a_h, a_w, h, w, c, wiener, "float32",
                             str(x.device), chain_dtype=chain)
    xp = _flat_pad(x, sp.pad)
    bp = _flat_pad(basic, sp.pad) if wiener else None
    mp = bp if wiener else xp
    noisy_pl = xp.permute(3, 0, 1, 2).contiguous()
    basic_pl = bp.permute(3, 0, 1, 2).contiguous() if wiener else None
    r = step.refs[0] if ref is None else ref
    fmask = step.flat_mask(noisy_pl, sigma_c)
    sim_y, sim_x, lvl, mask, bidx = step.block_match(
        mp[..., 0].contiguous(), r, fmask
    )
    num = torch.zeros_like(noisy_pl)
    wden = torch.zeros_like(noisy_pl)

    def run(f, **kw):
        num.zero_()
        wden.zero_()
        f(noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask, r, sigma_c,
          step.tables, num, wden, k=sp.k, nd=sp.n_disp, lambda_3d=lam,
          wiener=wiener, **kw)

    return dict(sp=sp, step=step, noisy_pl=noisy_pl, basic_pl=basic_pl,
                bidx=bidx, sim_y=sim_y, sim_x=sim_x, lvl=lvl, mask=mask,
                num=num, wden=wden, run=run, ref=r, lam=lam,
                sigma_c=sigma_c, wiener=wiener)


def raw_group_step(lib, g, banked, bf16) -> None:
    """One launch of a group kernel's C entry point from `lib` (this tree's,
    the counter build or a parent's) on group_setup g's inputs, num/wden
    zeroed first: what the wrapper launches, without it."""
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.kernels.fused import _pointers

    noisy, sp, tables = g["noisy_pl"], g["sp"], g["step"].tables
    c, a, hp, wp = noisy.shape
    t, n_sim = g["sim_y"].shape
    g["num"].zero_()
    g["wden"].zero_()
    entry = "lfbm5d_group_step_banked" if banked else "lfbm5d_group_step"
    rc = getattr(lib, entry)(
        *_pointers(noisy, g["basic_pl"], g["bidx"], None, g["sim_y"],
                   g["sim_x"], g["lvl"], g["mask"], g["sigma_c"], tables,
                   g["num"], g["wden"], g["wiener"]),
        t, n_sim, a, tables.a_h, tables.a_w, c, hp, wp, hp - sp.k + 1,
        wp - sp.k + 1, sp.n_disp, g["ref"], int(g["wiener"]), int(bf16),
        float(g["lam"]), _build.stream_of(noisy))
    if rc:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.lfbm5d_error_string(rc).decode()})")


def plan_line(lib, fn_name, n_sim, a_h, a_w, wiener) -> str:
    """The group kernel's launch plan at this shape from the library (cs,
    threads, shared bytes, max active clusters, CTAs per SM); fails unless
    the Python copy (kernels/fused.py::group_plan) gives the same plan and
    at least one cluster fits on the card."""
    import ctypes

    from lfbm5d_torch.kernels._build import check
    from lfbm5d_torch.kernels.fused import group_plan

    out = (ctypes.c_int * 5)()
    fn = (lib.lfbm5d_group_occupancy_banked if "banked" in fn_name
          else lib.lfbm5d_group_occupancy)
    bf16 = int(fn_name.endswith("_bf16"))
    check(fn(n_sim, a_h, a_w, int(wiener), bf16, out),
          f"{fn_name} occupancy")
    py = group_plan(n_sim, a_h, a_w, wiener, bool(bf16))
    if tuple(out[:3]) != py:
        raise AssertionError(f"{fn_name} N={n_sim} {a_h}x{a_w}: library plan "
                             f"{tuple(out[:3])} vs Python {py}")
    if out[3] < 1:
        raise AssertionError(f"{fn_name} N={n_sim} {a_h}x{a_w}: no cluster "
                             f"of {out[0]} CTAs fits on the card")
    return (f"cs {out[0]}, {out[1]} threads, {out[2]} B shared per CTA, "
            f"max active clusters {out[3]}, CTAs per SM {out[4]}")


def plan_table(lib) -> None:
    """(a): the plan of every group-kernel shape the phases launch (the
    matched, default and robust presets and matched at N=1, at 1x1, 3x3,
    9x9, 17x17 and 19x19; the bf16 instantiations at 9x9; (q)'s non-square
    grids, f32 and, where A <= 128, bf16), Python copy == library, printed
    before the first timed run."""
    from lfbm5d_torch import preset_denoise_params
    from lfbm5d_torch.pipeline.engine import resolve_route

    seen = set()
    for preset, over in (("matched", {}), ("default", {}), ("robust", {}),
                         ("matched", dict(n_sim=1))):
        pp = preset_denoise_params(preset, 25.0)
        for sp, wiener in ((pp.ht.replace(**over), False),
                           (pp.wiener.replace(**over), True)):
            for side in (1, 3, 9, 17, 19):
                route = resolve_route(sp, side, side)
                key = (route, sp.n_sim, side, wiener)
                if route == "two_kernel" or key in seen:
                    continue
                seen.add(key)
                fn = ("fused_group_step" if route == "fused"
                      else "fused_group_step_banked")
                for f in (fn, fn + "_bf16") if side == 9 else (fn,):
                    print(f"(a) plan {f} N={sp.n_sim} {side}x{side} "
                          f"{'Wiener' if wiener else 'HT'}: "
                          f"{plan_line(lib, f, sp.n_sim, side, side, wiener)}")
    # (q)'s non-square grids (its end-to-end runs launch the same shapes)
    for a_h, a_w, preset in NONSQUARE:
        pp = preset_denoise_params(preset, 25.0)
        for sp, wiener in ((pp.ht, False), (pp.wiener, True)):
            fn = nonsquare_kernel(sp, a_h, a_w)
            for f in (fn, fn + "_bf16") if a_h * a_w <= 128 else (fn,):
                print(f"(a) plan {f} N={sp.n_sim} {a_h}x{a_w} "
                      f"{'Wiener' if wiener else 'HT'}: "
                      f"{plan_line(lib, f, sp.n_sim, a_h, a_w, wiener)}")


def group_check(label, params, x, basic, sigma_c, wiener, fn_name, lib,
                timed=True, rel_max=GROUP_REL_MAX, ref=None):
    """A group kernel vs plain at the first reference SAI of one step (or at
    SAI `ref`): (max |delta|, kernel ms, plain ms, bound ms, bound_by,
    setup; setup["rel"] the larger relative L2 of num and den); the times
    None unless timed (CUDA events time the current device only). A *_bf16
    kernel runs with bf16 tables, as its plain version."""
    import torch

    from lfbm5d_torch.kernels import fused as kf

    fn = getattr(kf, fn_name)
    chain = torch.bfloat16 if fn_name.endswith("_bf16") else None
    g = group_setup(params, x, basic, sigma_c, wiener, chain, ref)
    run, num, wden, mask, lvl = (g["run"], g["num"], g["wden"], g["mask"],
                                 g["lvl"])
    a_h, a_w, _, _, c = x.shape
    plan = plan_line(lib, fn_name, g["sp"].n_sim, a_h, a_w, wiener)
    run(fn)
    nk, dk = num.clone(), wden.clone()
    run(kf.fused_group_step_plain)
    rel_n = float((nk - num).norm() / num.norm())
    rel_d = float((dk - wden).norm() / wden.norm())
    err = max(float((nk - num).abs().max()), float((dk - wden).abs().max()))
    g["rel"] = max(rel_n, rel_d)
    live = int(mask[:, 0].sum())
    msg = (f"{label} {fn_name} {'Wiener' if wiener else 'HT'} (route "
           f"{g['step'].route}; {plan}): {live}/{mask.shape[0]} live groups, "
           f"rel num {rel_n:.2e}, rel den {rel_d:.2e}, max |d| {err:.3e}")
    ms = pms = None
    if timed:
        ms = cuda_ms(lambda: run(fn))
        pms = cuda_ms(lambda: run(kf.fused_group_step_plain), reps=2)
        msg += f"; kernel {ms:.3f} ms, plain {pms:.3f} ms"
    print(msg)
    if not rel_n <= rel_max or not rel_d <= rel_max:
        raise AssertionError(f"{fn_name} ({label}) disagrees with plain")
    moved = nbytes(g["noisy_pl"], g["basic_pl"], g["bidx"], g["sim_y"],
                   g["sim_x"], lvl, mask, g["step"].tables.packed) + 2 * nbytes(
                       num)
    if chain is not None:
        moved += nbytes(g["step"].tables.dense)
    bms, by = bound(moved, *group_flops(lvl, mask, c, a_h, a_w, wiener,
                                        dense=chain is not None))
    return err, ms, pms, bms, by, g


def two_kernel_case(sp, lam, x, sigma_c, doff_mode="direct", ref=None):
    """The two-kernel route's inputs at the first reference SAI (or at SAI
    `ref`) of an HT step of step params sp on LF x: (planes, (bidx, sim_y,
    sim_x, mask, ref), doff (None when direct), Kaiser window [k*k])."""
    from lfbm5d_torch.pipeline.denoise import _flat_pad
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    a_h, a_w, h, w, c = x.shape
    step = build_kernel_step(sp, lam, a_h, a_w, h, w, c, False, "float32",
                             str(x.device), False, doff_mode)
    xp = _flat_pad(x, sp.pad)
    pl = xp.permute(3, 0, 1, 2).contiguous()
    r = step.refs[0] if ref is None else ref
    sy, sx, _, mask, bidx = step.block_match(
        xp[..., 0].contiguous(), r, step.flat_mask(pl, sigma_c))
    return (pl, (bidx, sy, sx, mask, r), step.slot_table(bidx, sy, sx),
            step.tables.kaiser.reshape(-1))


def _rel(got, want) -> float:
    """L2 distance relative to want; max |got| where want is all zero."""
    norm = float(want.norm())
    return (float((got - want).norm()) / norm if norm else
            float(got.abs().max()))


def hold_two_kernel(label, pl, geo, doff, kai, k, nd, tag="(e)"):
    """extract_groups exactly equal to its plain version, and both
    accumulate forms within ACC_REL_MAX of theirs, at one two-kernel shape;
    (group tensor, weighted values, per-slot weights, the largest relative
    L2 of the accumulate outputs)."""
    import torch

    from lfbm5d_torch.kernels.accumulate import (
        accumulate_groups, accumulate_groups_fused,
        accumulate_groups_fused_plain, accumulate_groups_plain,
    )
    from lfbm5d_torch.kernels.extract import (
        extract_groups, extract_groups_plain, twokernel_plan,
    )

    mask = geo[3]
    g = extract_groups(pl, *geo, k=k, nd=nd, doff=doff)
    exact = bool(torch.equal(g, extract_groups_plain(pl, *geo, k=k, nd=nd,
                                                     doff=doff)))
    gen = torch.Generator(device=pl.device).manual_seed(0)
    wv = torch.rand(g.shape[:3], device=pl.device, generator=gen) * mask[None]
    vals = g * (wv[..., None, None] * kai[:, None])
    nk, dk, npl, dpl = (torch.zeros_like(pl) for _ in range(4))
    accumulate_groups_fused(vals, wv, kai, *geo, nk, dk, k=k, nd=nd,
                            doff=doff)
    accumulate_groups_fused_plain(vals, wv, kai, *geo, npl, dpl, k=k, nd=nd,
                                  doff=doff)
    rel_n, rel_d = _rel(nk, npl), _rel(dk, dpl)
    nk.zero_()
    npl.zero_()
    accumulate_groups(vals, *geo, nk, k=k, nd=nd, doff=doff)
    accumulate_groups_plain(vals, *geo, npl, k=k, nd=nd, doff=doff)
    rel_1 = _rel(nk, npl)
    p, a = pl.shape[:2]
    print(f"{tag} two-kernel {label} (k={k}, nd={nd}, P={p}, A={a}, S="
          f"{mask.numel()}, live {int(mask.sum())}, doff "
          f"{doff is not None}; plan {twokernel_plan(k, a)}): extract exact "
          f"{exact}; accumulate_groups_fused rel num {rel_n:.2e}, den "
          f"{rel_d:.2e}; accumulate_groups rel {rel_1:.2e}")
    if not exact:
        raise AssertionError(f"extract_groups ({label}) disagrees with plain")
    if max(rel_n, rel_d, rel_1) > ACC_REL_MAX:
        raise AssertionError(f"accumulate ({label}) disagrees with plain")
    return g, vals, wv, max(rel_n, rel_d, rel_1)


def two_kernel_shapes(params, x17, big, sigma_c):
    """(e): extract and both accumulate forms vs plain at the two-kernel
    route's edge shapes: a chunk of 17x17x512x512 (the engine's chunk size),
    k in {4, 12, 16} with nd in {0, 2} (A = 289 and the even A = 400), A
    tiled (k = 16 at 33x33), A = 1 (flat_tau 0, as in `edge_checks`), a doff
    table and an all-masked chunk.
    The table shape (17x17x128x128) is `two_kernel_checks`'."""
    import torch

    from lfbm5d_torch.lf import color_matrix
    from lfbm5d_torch.pipeline.engine import TWO_KERNEL_CHUNK_BYTES

    dev = x17.device
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    sp, lam = params.ht, params.lambda_3d
    pl, geo, _, kai = two_kernel_case(sp, lam, big, sigma_c)
    c, a = pl.shape[:2]
    chunk = TWO_KERNEL_CHUNK_BYTES // (c * sp.n_sim * sp.k**2 * a * 4)
    bidx, sy, sx, mask, r = geo
    hold_two_kernel("17x17x512x512 first chunk", pl,
                    (bidx, sy[:chunk].contiguous(), sx[:chunk].contiguous(),
                     mask[:chunk].contiguous(), r), None, kai, sp.k,
                    sp.n_disp)
    del pl, geo, bidx, sy, sx, mask
    x20 = lf_on_card(20, 32, 32, 1, dev)[0] @ m.T
    x33 = lf_on_card(33, 24, 24, 1, dev)[0] @ m.T
    x1 = lf_on_card(1, 64, 64, 1, dev)[0] @ m.T
    for k, nd, lf, name in ((4, 0, x20, "20x20x32x32"),
                            (4, 2, x20, "20x20x32x32"),
                            (12, 0, x17, "17x17x32x32"),
                            (12, 2, x17, "17x17x32x32"),
                            (16, 0, x17, "17x17x32x32"),
                            (16, 2, x20, "20x20x32x32"),
                            (16, 1, x33, "33x33x24x24 (SAI tiles)"),
                            (8, 1, x1, "1x1x64x64")):
        spk = sp.replace(k=k, n_disp=nd, n_search=8,
                         flat_tau=sp.flat_tau if lf.shape[0] > 1 else 0.0)
        pl, geo, _, kai = two_kernel_case(spk, lam, lf, sigma_c)
        hold_two_kernel(name, pl, geo, None, kai, k, nd)
    pl, geo, doff, kai = two_kernel_case(sp, lam, x17, sigma_c, "take")
    hold_two_kernel("17x17x32x32 doff table", pl, geo, doff, kai, sp.k,
                    sp.n_disp)
    masked = (*geo[:3], torch.zeros_like(geo[3]), geo[4])
    hold_two_kernel("17x17x32x32 all masked", pl, masked, None, kai, sp.k,
                    sp.n_disp)


def two_kernel_checks(params, x, sigma_c):
    """extract_groups and both accumulate forms vs plain at the first
    reference SAI of the 17x17x128x128 HT step (one chunk of every group):
    the kernels line's rows (ms, plain ms, bound, library call)."""
    import torch

    from lfbm5d_torch.kernels.accumulate import (
        accumulate_groups, accumulate_groups_fused,
        accumulate_groups_fused_plain, accumulate_groups_plain,
    )
    from lfbm5d_torch.kernels.extract import (
        extract_groups, extract_groups_plain, patch_coords,
    )

    sp = params.ht
    k, nd = sp.k, sp.n_disp
    pl, geo, _, kai = two_kernel_case(sp, params.lambda_3d, x, sigma_c)
    bidx, sy, sx, mask, r = geo
    c = pl.shape[0]
    g, vals, wv, _ = hold_two_kernel("17x17x128x128 (the table shape)", pl,
                                     geo, None, kai, k, nd)
    rows = {}
    ms = cuda_ms(lambda: extract_groups(pl, *geo, k=k, nd=nd))
    pms = cuda_ms(lambda: extract_groups_plain(pl, *geo, k=k, nd=nd), reps=2)
    yy, xx, a_i = patch_coords(bidx, sy, sx, r, k, nd)
    p_i = torch.arange(c, device=pl.device)[:, None, None, None, None]
    flat = (((p_i * pl.shape[1] + a_i) * pl.shape[2] + yy) * pl.shape[3]
            + xx).contiguous()  # gather indices, precomputed (not timed)
    lib = cuda_ms(lambda: torch.take(pl, flat))
    print(f"(e) extract_groups {tuple(g.shape)}: kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms, torch.take {lib:.3f} ms")
    bms, by = bound(nbytes(pl, g, bidx, sy, sx, mask), 0)
    rows["extract_groups"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by, library_ms=lib)

    nk, dk, npl, dpl = (torch.zeros_like(pl) for _ in range(4))
    accumulate_groups_fused(vals, wv, kai, *geo, nk, dk, k=k, nd=nd)
    accumulate_groups_fused_plain(vals, wv, kai, *geo, npl, dpl, k=k, nd=nd)
    err = max(float((nk - npl).abs().max()), float((dk - dpl).abs().max()))
    ms = cuda_ms(lambda: accumulate_groups_fused(vals, wv, kai, *geo, nk, dk,
                                                 k=k, nd=nd))
    pms = cuda_ms(lambda: accumulate_groups_fused_plain(
        vals, wv, kai, *geo, npl, dpl, k=k, nd=nd), reps=2)
    print(f"(e) accumulate_groups_fused: max |d| {err:.3e}; kernel {ms:.4f} "
          f"ms, plain {pms:.3f} ms")
    live = float(mask.sum()) * c * k * k * pl.shape[1]
    bms, by = bound(nbytes(vals, wv, bidx, sy, sx, mask) + 2 * nbytes(pl),
                    3 * live)
    rows["accumulate_groups_fused"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None)

    nk.zero_()
    npl.zero_()
    accumulate_groups(vals, *geo, nk, k=k, nd=nd)
    accumulate_groups_plain(vals, *geo, npl, k=k, nd=nd)
    err = float((nk - npl).abs().max())
    ms = cuda_ms(lambda: accumulate_groups(vals, *geo, nk, k=k, nd=nd))
    pms = cuda_ms(lambda: accumulate_groups_plain(vals, *geo, npl, k=k,
                                                  nd=nd), reps=2)
    src = vals.expand(c, *yy.shape)
    lib = cuda_ms(lambda: npl.view(-1).index_add_(0, flat.view(-1),
                                                  src.reshape(-1)))
    print(f"(e) accumulate_groups: max |d| {err:.3e}; kernel {ms:.4f} ms, "
          f"plain {pms:.3f} ms, index_add_ {lib:.3f} ms")
    bms, by = bound(nbytes(vals, bidx, sy, sx, mask, pl), live)
    rows["accumulate_groups"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                     bound_ms=bms, bound_by=by,
                                     library_ms=lib)
    return rows


def edge_checks(params, small, small_basic, sigma_c, lib):
    """(e): the kernels at the edge shapes no earlier phase launches, each
    vs its plain version: the group kernel at an A = 1 cluster plan
    (1x1x64x64) and with N = 1 groups (9x9x64x96), HT and Wiener; the BM
    kernels at nd = 0 (9x9x64x96, mismatch 0)."""
    import torch

    from lfbm5d_torch.lf import color_matrix

    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32,
                        device=small.device)
    x1 = lf_on_card(1, 64, 64, 1, small.device)[0] @ m.T
    # one SAI has no angular redundancy to measure: every group would be
    # flat (masked) at the preset's flat_tau
    p1 = params.replace(ht=params.ht.replace(flat_tau=0.0),
                        wiener=params.wiener.replace(flat_tau=0.0))
    for basic, wiener in ((None, False), (x1 + 0.5, True)):
        group_check("(e) 1x1x64x64 matched, flat_tau 0", p1, x1, basic,
                    sigma_c, wiener, "fused_group_step", lib, timed=False)
    n1 = params.replace(ht=params.ht.replace(n_sim=1),
                        wiener=params.wiener.replace(n_sim=1))
    for basic, wiener in ((None, False), (small_basic, True)):
        group_check("(e) 9x9x64x96 N=1", n1, small, basic, sigma_c, wiener,
                    "fused_group_step", lib, timed=False)
    phase_bm("(e) 9x9x64x96 nd=0", bm_ctx(params.ht.replace(n_disp=0),
                                           small))


def second_card(params):
    """(e) with more than one card: one extract check and one group check
    on cuda:1 while cuda:0 is current, so each wrapper has to launch on its
    tensors' device."""
    import torch

    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.lf import color_matrix

    if torch.cuda.device_count() < 2:
        print("(e) one card: the cuda:1 checks need a second one")
        return
    dev = torch.device("cuda:1")
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    x = lf_on_card(9, 64, 96, 1, dev)[0] @ m.T
    sig = _sigma(dev)
    sp = params.ht
    pl, geo, _, kai = two_kernel_case(sp, params.lambda_3d, x, sig)
    hold_two_kernel("9x9x64x96 on cuda:1", pl, geo, None, kai, sp.k,
                    sp.n_disp)
    group_check("(e) 9x9x64x96 on cuda:1", params, x, None, sig, False,
                "fused_group_step", _build.library(), timed=False)
    torch.cuda.synchronize(dev)
    if torch.cuda.current_device() != 0:
        raise AssertionError("a wrapper left cuda:1 current")


def gather_case(params, x, sigma_c):
    """The `dma` mode's row gather at reference SAI 0 of x (OPP, on the
    card): (step, bidx, sim_y, sim_x, table [V0*V1, A] int32, rows [T*N])."""
    from lfbm5d_torch.pipeline.denoise import _flat_pad
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    sp = params.ht
    a_h, a_w, h, w, c = x.shape
    step = build_kernel_step(sp, params.lambda_3d, a_h, a_w, h, w, c, False,
                             "float32", str(x.device), None, "dma")
    xp = _flat_pad(x, sp.pad)
    pl = xp.permute(3, 0, 1, 2).contiguous()
    sim_y, sim_x, _, _, bidx = step.block_match(
        xp[..., 0].contiguous(), step.refs[0], step.flat_mask(pl, sigma_c))
    a, _, v1 = bidx.shape
    table = bidx.view(a, -1).t().contiguous()
    return step, bidx, sim_y, sim_x, table, (sim_y * v1 + sim_x).view(-1)


def phase_gather(params, x, x17, sigma_c):
    """(j): gather_rows exactly equal to its plain version at the flagship's
    `dma` shape, at 17x17x128x128's (W = 289) and at GATHER_RAGGED's; at the
    flagship the kernel and index_select timed in turns on a cold L2
    (device time, the host's submission outside the window) and on the
    host's clock (per call); the kernels row."""
    import torch

    from lfbm5d_torch.kernels.gather import gather_rows, gather_rows_plain

    shapes = set(gather_shapes(params))
    step, bidx, sim_y, sim_x, table, rows = gather_case(params, x, sigma_c)
    out = gather_rows(table, rows)
    exact = bool(torch.equal(out, gather_rows_plain(table, rows)))
    same = bool(torch.equal(out.view(*sim_y.shape, bidx.shape[0]),
                            step.slot_table(bidx, sim_y, sim_x)))
    launched = [(rows.numel(), table.shape[1])]
    rows_l = rows.long()  # index_select's index type, converted untimed
    # yardstick: one device-to-device copy of the output's size (reads and
    # writes about the bytes the gather must move)
    src, dst = torch.ones_like(out), torch.empty_like(out)
    fns = (lambda: gather_rows(table, rows),
           lambda: table.index_select(0, rows_l), lambda: dst.copy_(src))
    (ms, lo, hi), (lib, llo, lhi), (cp, clo, chi) = cold_rounds(fns)
    k_us, l_us = host_us(fns[0]), host_us(fns[1])
    pms = cuda_ms_cold(lambda: gather_rows_plain(table, rows))
    warm = cuda_ms(fns[0])
    # bytes the function must move: the indices, each distinct row of the
    # table once, and the output
    need = int(torch.unique(rows).numel()) * table.shape[1] * 4
    bms, by = bound(nbytes(rows, out) + need, 0)
    print(f"(j) gather_rows table {tuple(table.shape)} int32 "
          f"({nbytes(table) / 1e6:.1f} MB), {rows.numel()} rows: exact "
          f"{exact}, equal to the step's slot_table {same}")
    print(f"(j) device time, cold L2, {GATHER_ROUNDS} rounds in turns (spin "
          f"{spin_ms():.3f} ms before each window): kernel median {ms:.4f} "
          f"ms (min {lo:.4f}, max {hi:.4f}), index_select median {lib:.4f} "
          f"ms (min {llo:.4f}, max {lhi:.4f}); kernel {lib / ms:.2f}x "
          f"index_select; a copy of the output's {nbytes(out) / 1e6:.1f} MB "
          f"(copy_) median {cp:.4f} ms (min {clo:.4f}, max {chi:.4f}); bound "
          f"{bms:.4f} ms ({by}), kernel at {bms / ms:.0%} of it; plain "
          f"{pms:.4f} ms; kernel warm {warm:.4f} ms")
    print(f"(j) host time per call ({GATHER_HOST_CALLS} calls, no "
          f"synchronisation): kernel wrapper {k_us:.1f} us, index_select "
          f"{l_us:.1f} us")
    if not (exact and same):
        raise AssertionError("gather_rows disagrees with its plain version")
    # W = 289: 17x17x128x128 matched, reference SAI 0
    _, _, _, _, t17, r17 = gather_case(params, x17, sigma_c)
    checks = [(t17, r17, "17x17x128x128 dma")]
    gen = torch.Generator(device=x.device).manual_seed(0)
    for v, w, n, dt in GATHER_RAGGED:
        tab = torch.randn((v, w), generator=gen, device=x.device)
        if dt == "int32":
            tab = (tab * 1e6).to(torch.int32)
        idx = torch.randint(0, v, (n,), generator=gen, device=x.device,
                            dtype=torch.int32)
        checks.append((tab, idx, f"{dt} V={v}"))
    for tab, idx, label in checks:
        got = gather_rows(tab, idx)
        ok = bool(torch.equal(got, gather_rows_plain(tab, idx)))
        launched.append((idx.numel(), tab.shape[1]))
        print(f"(j) gather_rows {label}, S={idx.numel()}, W={tab.shape[1]}: "
              f"exact {ok}")
        if not ok:
            raise AssertionError(f"gather_rows ({label}) disagrees with its "
                                 f"plain version")
    if not shapes.issuperset(launched):
        raise AssertionError(f"(a) did not check the plan of "
                             f"{set(launched) - shapes}")
    return dict(max_abs_err=0, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lib)


def bf16_kernel_row(label, params, x, basic_w, sig, fn_name, lib):
    """(p): a bf16 group kernel vs its bf16 plain version, HT then Wiener,
    at the first reference SAI of x, and the f32 kernel on the same
    reference in turns (f32, bf16, bf16, f32): the kernels line's row
    (HT + Wiener summed)."""
    import torch

    from lfbm5d_torch.kernels import fused as kf

    f32_fn = getattr(kf, fn_name[:-len("_bf16")])
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for basic, wiener in ((None, False), (basic_w, True)):
        err, _, pms, bms, by, g16 = group_check(
            f"(p) {label}", params, x, basic, sig, wiener, fn_name, lib,
            timed=False, rel_max=GROUP_BF16_REL_MAX)
        g32 = group_setup(params, x, basic, sig, wiener)
        if not (torch.equal(g32["sim_y"], g16["sim_y"])
                and torch.equal(g32["bidx"], g16["bidx"])):
            raise AssertionError(f"(p) {label}: the two steps' BM differs")
        f32_run = (lambda: g32["run"](f32_fn))
        bf16_run = (lambda: g16["run"](getattr(kf, fn_name)))
        ms = [cuda_ms(f) for f in (f32_run, bf16_run, bf16_run, f32_run)]
        k32, k16 = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        pms = cuda_ms(lambda: g16["run"](kf.fused_group_step_plain), reps=2)
        print(f"(p) {label} {'Wiener' if wiener else 'HT'}: {fn_name} "
              f"{ms[1]:.3f} / {ms[2]:.3f} ms, f32 kernel {ms[0]:.3f} / "
              f"{ms[3]:.3f} ms (bf16/f32 {k16 / k32:.3f}x); bf16 plain "
              f"{pms:.3f} ms; bound {bms:.3f} ms ({by})")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += k16
        row["plain_ms"] += pms
        row["bound_ms"] += bms
        row["bound_by"] = by
    return row


def phase_bf16(kernels, lib, params, sig, m, d_final, h_ref):
    """(p): the bfloat16 transform chain (module docstring): kernels vs
    plain, the flagship, the N=16 presets, the 289-SAI fall-through.
    Returns ({bf16 kernel: row}, {bf16 kernel: launches})."""
    import torch

    from lfbm5d_torch import preset_denoise_params, psnr_device, run_bm5d
    from lfbm5d_torch.lf import add_noise_np, synthetic_lf
    from lfbm5d_torch.pipeline.denoise import _raw_step, ht_step
    from lfbm5d_torch.pipeline.engine import resolve_route

    dev = torch.device("cuda:0")
    bm_path = ["self_distances_kernel", "cross_argmin_all_kernel"]
    rows, launches = {}, {}
    small = lf_on_card(9, 64, 96, 1)[0] @ m.T
    small_basic = ht_step(small, 25.0, params.ht, params.lambda_3d, "opp",
                          engine="auto", device=dev)
    for basic, wiener in ((None, False), (small_basic, True)):
        group_check("(p) 9x9x64x96", params, small, basic, sig, wiener,
                    "fused_group_step_bf16", lib, timed=False,
                    rel_max=GROUP_BF16_REL_MAX)
    # the tensor-core angular pass at the other tile counts (one kernel
    # instantiation each: 1x1 1, 5x5 2, 6x6 3, 8x8 4, 10x10 7, 11x11 8) and
    # even grids, on both kernels
    for side, h, w, preset in ((8, 32, 48, "matched"), (8, 32, 48, "default"),
                               (11, 24, 32, "matched"), (1, 32, 32, "matched"),
                               (5, 24, 32, "matched"), (6, 24, 32, "matched"),
                               (10, 24, 32, "matched")):
        pp = preset_denoise_params(preset, 25.0)
        if side == 1:  # one SAI: every group is flat at the preset's flat_tau
            pp = pp.replace(ht=pp.ht.replace(flat_tau=0.0),
                            wiener=pp.wiener.replace(flat_tau=0.0))
        lf = lf_on_card(side, h, w, 1)[0] @ m.T
        fn = {"fused": "fused_group_step_bf16",
              "banked": "fused_group_step_banked_bf16"}[
                  resolve_route(pp.ht, side, side)]
        for basic, wiener in ((None, False), (lf + 0.5, True)):
            group_check(f"(p) {side}x{side}x{h}x{w} {preset}", pp, lf, basic,
                        sig, wiener, fn, lib, timed=False,
                        rel_max=GROUP_BF16_REL_MAX)
        del lf
    dflt = preset_denoise_params("default", 25.0)
    rows["fused_group_step_banked_bf16"] = bf16_kernel_row(
        "9x9x64x96 default", dflt, small, small_basic, sig,
        "fused_group_step_banked_bf16", lib)
    del small, small_basic
    noisy, clean = lf_on_card(9, 434, 625, 1)
    rows["fused_group_step_bf16"] = bf16_kernel_row(
        "flagship", params, noisy @ m.T, clean @ m.T, sig,
        "fused_group_step_bf16", lib)

    path = bm_path + ["fused_group_step_bf16"]
    t0 = time.perf_counter()
    run_bm5d(noisy, params, engine="auto_bf16")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ((basic, final), dt), counts = drive(
        "(p) flagship auto_bf16", kernels, path,
        lambda: timed_run(noisy, params, engine="auto_bf16"))
    launches["fused_group_step_bf16"] = counts["fused_group_step_bf16"]
    if counts["fused_group_step"] or counts["fused_group_step_banked"]:
        raise AssertionError(f"auto_bf16 launched an f32 group kernel: "
                             f"{counts}")
    peak = torch.cuda.max_memory_allocated()
    if tuple(final.shape) != tuple(noisy.shape) or not bool(
            torch.isfinite(final).all() & torch.isfinite(basic).all()):
        raise AssertionError("auto_bf16 flagship output has the wrong shape "
                             "or non-finite values")
    p_basic, p_final = psnr_device(basic, clean), psnr_device(final, clean)
    mpix = 9 * 9 * 434 * 625 / 1e6
    delta = p_final - d_final
    print(f"(p) flagship 9x9x434x625 RGB matched auto_bf16: warm run "
          f"{warm:.3f} s, timed run {dt:.4f} s/LF = {mpix / dt:.3f} Mpix/s; "
          f"PSNR basic {p_basic:.3f} / final {p_final:.4f} dB ((d) f32 "
          f"{d_final:.4f}, delta {delta:+.4f}); peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"(p) ROADMAP trap 4 (bf16 in the default chain needs a record "
          f"within {TRAP4_PSNR_DELTA} dB of f32): "
          f"{'met' if abs(delta) <= TRAP4_PSNR_DELTA else 'not met'} "
          f"({delta:+.4f} dB); auto stays f32")
    if (p_final < PSNR_FINAL_MIN or p_basic < PSNR_BASIC_MIN
            or abs(p_final - d_final) > BF16_PSNR_DELTA_MAX):
        raise AssertionError(f"auto_bf16 flagship PSNR: basic {p_basic:.3f},"
                             f" final {p_final:.4f} vs f32 {d_final:.4f}")
    del noisy, clean, basic, final

    lf_h = add_noise_np(synthetic_lf(9, 9, 24, 32, channels=3, seed=0),
                        25.0, seed=1)
    clean_h = synthetic_lf(9, 9, 24, 32, channels=3, seed=0)
    path = bm_path + ["fused_group_step_banked_bf16"]
    for preset in ("default", "robust"):
        ph = preset_denoise_params(preset, 25.0)
        (_, f16), counts = drive(
            f"(p) {preset} auto_bf16", kernels, path,
            lambda: run_bm5d(lf_h, ph, engine="auto_bf16", device=dev))
        if preset == "default":
            launches["fused_group_step_banked_bf16"] = counts[
                "fused_group_step_banked_bf16"]
        p16 = psnr_device(f16, clean_h)
        print(f"(p) {preset} 9x9x24x32 RGB auto_bf16 (route banked): "
              f"{p16:.3f} dB vs (h)'s plain f64 {h_ref[preset]:.3f} dB "
              f"(delta {p16 - h_ref[preset]:+.4f})")
        if abs(p16 - h_ref[preset]) > PSNR_DELTA_MAX:
            raise AssertionError(f"{preset} auto_bf16 disagrees with the "
                                 f"f64 reference")

    x17, c17 = lf_on_card(17, 32, 32, 1)
    keys = [(params.ht, params.lambda_3d, 17, 17, 32, 32, 3, params.chunk,
             False, "float32", eng, str(dev)) for eng in ("auto", "auto_bf16")]
    if _raw_step(*keys[0]) is not _raw_step(*keys[1]):
        raise AssertionError("auto_bf16 at 289 SAIs is not the f32 step")
    finals = {}
    for eng in ("auto", "auto_bf16"):
        (_, finals[eng]), counts = drive(
            f"(p) 17x17x32x32 {eng}", kernels,
            bm_path + ["fused_group_step_banked"],
            lambda: run_bm5d(x17, params, engine=eng))
        if counts["fused_group_step_banked_bf16"]:
            raise AssertionError("a bf16 kernel ran beyond 128 SAIs")
    rel = _rel(finals["auto_bf16"], finals["auto"])
    print(f"(p) 17x17x32x32 RGB matched: auto_bf16 runs auto's step (route "
          f"{_raw_step(*keys[1]).route}, chain None); final rel L2 vs auto "
          f"{rel:.2e}; PSNR {psnr_device(finals['auto_bf16'], c17):.3f} dB")
    if rel > A_GT_128_REL_MAX:
        raise AssertionError("auto_bf16 beyond 128 SAIs differs from auto")
    return rows, launches


def nonsquare_kernel(sp, a_h, a_w) -> str:
    """The f32 group kernel of step params sp's route at an aH x aW grid
    (resolve_route; (q) holds no two_kernel step through a group kernel)."""
    from lfbm5d_torch.pipeline.engine import resolve_route

    return {"fused": "fused_group_step", "banked": "fused_group_step_banked"}[
        resolve_route(sp, a_h, a_w)]


def interior_ref(a_h: int, a_w: int) -> int:
    """(q)'s reference SAI: (1, 3) clipped to the grid, so s != t and the
    kernels decode a row and a column other than 0."""
    return min(1, a_h - 1) * a_w + min(3, a_w - 1)


def phase_nonsquare(kernels, lib, sig, m) -> None:
    """(q): every kernel of the group stage held against its plain version
    at non-square angular grids (NONSQUARE, at an interior reference SAI
    with s != t): self-BM and cross-argmin exactly equal at 5x7 and 7x5;
    each grid's f32 group kernel within GROUP_REL_MAX and its bf16 one
    (A <= 128) within GROUP_BF16_REL_MAX, HT and Wiener (the clean LF as
    the Wiener guide); extract_groups exact and both accumulate forms
    within ACC_REL_MAX at 5x7 with a doff table. Then run_bm5d at
    NONSQUARE_RUNS' shapes, each engine within PSNR_DELTA_MAX final PSNR
    of the float64 plain pipeline run on the card, launching its route's
    kernel and no other group kernel."""
    import torch

    from lfbm5d_torch import preset_denoise_params, psnr_device, run_bm5d

    dev = m.device  # the color matrix's: cuda:0
    h, w = NONSQUARE_HW
    worst = {}  # kernel -> (largest relative L2 or mismatch, at which grid)

    def note(name, val, grid):
        if val >= worst.get(name, (-1.0, ""))[0]:
            worst[name] = (val, grid)

    for a_h, a_w, preset in NONSQUARE:
        pp = preset_denoise_params(preset, 25.0)
        noisy, clean = lf_on_card(a_h, h, w, 1, dev, a_w)
        x, guide = noisy @ m.T, clean @ m.T
        ref = interior_ref(a_h, a_w)
        grid = f"{a_h}x{a_w}x{h}x{w} {preset}"
        label = f"(q) {grid}, reference ({ref // a_w}, {ref % a_w})"
        if preset == "matched" and a_h * a_w == 35:
            for name, row in phase_bm(label, bm_ctx(pp.ht, x, ref)).items():
                note(name, row["max_abs_err"], grid)
        for basic, wiener in ((None, False), (guide, True)):
            sp = pp.wiener if wiener else pp.ht
            fn = nonsquare_kernel(sp, a_h, a_w)
            for f, rel_max in ((fn, GROUP_REL_MAX),
                               (fn + "_bf16", GROUP_BF16_REL_MAX)):
                if f.endswith("_bf16") and a_h * a_w > 128:
                    continue
                g = group_check(label, pp, x, basic, sig, wiener, f, lib,
                                timed=False, rel_max=rel_max, ref=ref)[5]
                note(f, g["rel"], f"{grid} {'Wiener' if wiener else 'HT'}")
        if (a_h, a_w, preset) == NONSQUARE[0]:
            sp = pp.ht
            pl, geo, doff, kai = two_kernel_case(sp, pp.lambda_3d, x, sig,
                                                 "take", ref)
            rel = hold_two_kernel(f"{grid} doff table, reference ({ref // a_w}"
                                  f", {ref % a_w})", pl, geo, doff, kai,
                                  sp.k, sp.n_disp, tag="(q)")[3]
            note("extract_groups", 0, grid)
            note("accumulate_groups_fused / accumulate_groups", rel, grid)
            del pl, geo, doff
        del noisy, clean, x, guide
    print("(q) largest disagreement per kernel over the grids: " + "; ".join(
        f"{name} {val:.2e} ({where})" for name, (val, where) in worst.items()))

    bm_path = ["self_distances_kernel", "cross_argmin_all_kernel"]
    for a_h, a_w, h, w, runs in NONSQUARE_RUNS:
        pp = preset_denoise_params("matched", 25.0)
        noisy, clean = lf_on_card(a_h, h, w, 1, dev, a_w)
        t0 = time.perf_counter()
        _, f64 = run_bm5d(noisy, pp, dtype="float64", engine="torch")
        p_ref = psnr_device(f64, clean)
        print(f"(q) {a_h}x{a_w}x{h}x{w} RGB matched: plain f64 (engine "
              f"torch, on the card) final {p_ref:.4f} dB in "
              f"{time.perf_counter() - t0:.1f} s")
        for eng, fused, kern in runs:
            path = bm_path + ([kern, "accumulate_groups_fused"]
                              if kern == "extract_groups" else [kern])
            tag = f"(q) {a_h}x{a_w}x{h}x{w} {eng} fused={fused}"
            (_, final), counts = drive(
                tag, kernels, path,
                lambda: run_bm5d(noisy, pp, engine=eng, fused=fused))
            others = {k: counts[k] for k in GROUP_KERNELS
                      if k != kern and counts[k]}
            p = psnr_device(final, clean)
            print(f"{tag}: final {p:.4f} dB (delta {p - p_ref:+.4f} vs plain "
                  f"f64)")
            if others:
                raise AssertionError(f"{tag} launched {others}")
            if (tuple(final.shape) != tuple(noisy.shape)
                    or not bool(torch.isfinite(final).all())
                    or abs(p - p_ref) > PSNR_DELTA_MAX):
                raise AssertionError(f"{tag} disagrees with the f64 plain "
                                     f"pipeline: {p:.4f} vs {p_ref:.4f} dB")
        del noisy, clean, f64


def phase_doff(kernels, path, params, noisy, clean, d_final, d_dt):
    """(k): the flagship with doff_mode take and dma (and direct again);
    gather_rows' launches on the dma run."""
    from lfbm5d_torch import psnr_device

    dma_launches = 0
    for mode in ("take", "dma", "direct"):
        timed_run(noisy, params, doff_mode=mode)
        run_path = path + (["gather_rows"] if mode == "dma" else [])
        ((_, final), dt), counts = drive(
            f"(k) {mode}", kernels, run_path,
            lambda: timed_run(noisy, params, doff_mode=mode))
        p = psnr_device(final, clean)
        print(f"(k) flagship matched doff_mode={mode}: {dt:.4f} s/LF "
              f"((d) direct {d_dt:.4f}); final PSNR {p:.3f} dB ((d) "
              f"{d_final:.3f})")
        if mode == "dma":
            dma_launches = counts["gather_rows"]
        elif counts["gather_rows"]:
            raise AssertionError(f"doff_mode={mode} launched gather_rows")
        if abs(p - d_final) > DOFF_PSNR_DELTA_MAX or p < PSNR_FINAL_MIN:
            raise AssertionError(f"doff_mode={mode}: final PSNR {p:.3f} vs "
                                 f"(d) {d_final:.3f}")
    return dma_launches


def phase_sr(kernels, path):
    """(l): x2 SR of the flagship, then a small SR against f64 plain."""
    import torch

    from lfbm5d_torch import psnr_device, run_sr
    from lfbm5d_torch.lf.resize import upsample

    lr, clean, sp = sr_flagship(9, 434, 624)
    p_bic = psnr_device(upsample(lr, 2), clean)
    warm = timed_sr(lr, sp)[1]
    torch.cuda.reset_peak_memory_stats()
    (hr, dt), _ = drive("(l)", kernels, path, lambda: timed_sr(lr, sp))
    peak = torch.cuda.max_memory_allocated()
    p_sr = psnr_device(hr, clean)
    mpix = 9 * 9 * 434 * 624 / 1e6
    print(f"(l) SR x2 9x9x217x312 -> 9x9x434x624 RGB ({sp.n_iter} "
          f"iterations, sigma {sp.sigma_init} -> {sp.sigma_final}): warm run "
          f"{warm:.3f} s, timed run {dt:.4f} s/LF = {mpix / dt:.3f} HR "
          f"Mpix/s; PSNR bicubic {p_bic:.3f} / SR {p_sr:.3f} dB; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    if (tuple(hr.shape) != tuple(clean.shape)
            or not bool(torch.isfinite(hr).all())):
        raise AssertionError("SR output has the wrong shape or non-finite "
                             "values")
    if p_sr < SR_PSNR_MIN or p_sr < p_bic + SR_OVER_BICUBIC_MIN:
        raise AssertionError(f"SR PSNR {p_sr:.3f} below the record or "
                             f"bicubic {p_bic:.3f} + {SR_OVER_BICUBIC_MIN}")
    del lr, clean, hr
    lr_s, clean_s, _ = sr_flagship(3, 32, 40)
    hr_k = run_sr(lr_s, sp, engine="auto")
    hr_p = run_sr(lr_s, sp, dtype="float64", engine="torch")
    d = psnr_device(hr_k, clean_s) - psnr_device(hr_p, clean_s)
    print(f"(l) SR 3x3x16x20 -> 3x3x32x40: kernels (f32) "
          f"{psnr_device(hr_k, clean_s):.3f} dB vs plain f64 "
          f"{psnr_device(hr_p, clean_s):.3f} dB (delta {d:+.4f})")
    if abs(d) > PSNR_DELTA_MAX:
        raise AssertionError("small SR disagrees with the f64 reference")


def phase_router(kernels, path, two_plane):
    """(m): the router on the flagship two-plane LF and on occl-grad, and
    the routed occl-grad denoise, timed once (probe included)."""
    import torch

    from lfbm5d_torch import (
        adaptive_denoise_params, psnr_device, run_bm5d,
    )
    from lfbm5d_torch import select_preset
    from lfbm5d_torch.lf import add_noise_np, synthetic_lf_multi

    name, stats = select_preset(two_plane, 25.0)
    print(f"(m) two-plane flagship (CUDA tensor): {name}, weak_fraction "
          f"{stats['weak_fraction']:.3f}")
    if name != "matched":
        raise AssertionError(f"the router sent the two-plane LF to {name}")
    t0 = time.perf_counter()
    clean_np = synthetic_lf_multi(9, 9, 434, 625, 3, **OCCL_GRAD)
    noisy = torch.as_tensor(add_noise_np(clean_np, 25.0, seed=1),
                            dtype=torch.float32, device="cuda:0")
    clean = torch.as_tensor(clean_np, dtype=torch.float32, device="cuda:0")
    print(f"(m) occl-grad 9x9x434x625 RGB made in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    def routed():
        t0 = time.perf_counter()
        params, name, stats = adaptive_denoise_params(noisy, 25.0, chunk=128)
        basic, final = run_bm5d(noisy, params)
        torch.cuda.synchronize()
        return name, stats, final, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    (name, stats, final, dt), _ = drive("(m) occl-grad", kernels, path,
                                        routed)
    p = psnr_device(final, clean)
    mpix = 9 * 9 * 434 * 625 / 1e6
    print(f"(m) occl-grad routed to {name} (weak_fraction "
          f"{stats['weak_fraction']:.3f}): {dt:.4f} s/LF = {mpix / dt:.3f} "
          f"Mpix/s, probe included; PSNR noisy "
          f"{psnr_device(noisy, clean):.3f} / "
          f"final {p:.3f} dB; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if name != "robust":
        raise AssertionError(f"the router sent occl-grad to {name}")
    if not bool(torch.isfinite(final).all()) or p < ROUTED_PSNR_MIN:
        raise AssertionError(f"routed occl-grad: final PSNR {p:.3f} below "
                             f"{ROUTED_PSNR_MIN}")


def flagship_batch():
    """The clean flagship two-plane LF (host float64) and its three noisy
    copies (BATCH_NOISE_SEEDS) for (n) and (o)."""
    from lfbm5d_torch.lf import add_noise_np, synthetic_lf

    clean = synthetic_lf(9, 9, 434, 625, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    return clean, [add_noise_np(clean, 25.0, seed=s)
                   for s in BATCH_NOISE_SEEDS]


def phase_batch(kernels, path, params, clean, noisy):
    """(n): denoise_batch over the three flagship LFs (a batch tensor on
    cuda:0; LF i on card i % count), each final within
    BATCH_PSNR_DELTA_MAX of run_bm5d on the same LF and >= PSNR_FINAL_MIN."""
    import torch

    from lfbm5d_torch import (
        denoise_batch, make_devices, psnr_device, run_bm5d,
    )

    devices = make_devices()
    lfs = torch.stack([torch.as_tensor(x, dtype=torch.float32)
                       for x in noisy]).to("cuda:0")
    ref = torch.as_tensor(clean, dtype=torch.float32, device="cuda:0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        out = denoise_batch(lfs, params, devices=devices)
        for d in devices:
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0

    ((basics, finals), dt), _ = drive("(n)", kernels, path, run)
    peak = torch.cuda.max_memory_allocated()
    if (tuple(finals.shape) != tuple(lfs.shape) or finals.device != lfs.device
            or not bool(torch.isfinite(finals).all())):
        raise AssertionError("denoise_batch: wrong shape, device or "
                             "non-finite values")
    mpix = 9 * 9 * 434 * 625 / 1e6
    print(f"(n) denoise_batch of {len(noisy)} flagship LFs (9x9x434x625 RGB,"
          f" matched, noise seeds {BATCH_NOISE_SEEDS}) over "
          f"{[str(d) for d in devices]}: {dt:.4f} s = {dt / len(noisy):.4f} "
          f"s/LF = {mpix * len(noisy) / dt:.3f} Mpix/s; peak device memory "
          f"(cuda:0) {peak / 2**30:.2f} GiB")
    for i, seed in enumerate(BATCH_NOISE_SEEDS):
        p_b = psnr_device(finals[i], ref)
        p_s = psnr_device(run_bm5d(lfs[i], params)[1], ref)
        print(f"(n) noise seed {seed}: final PSNR batch {p_b:.3f} dB, "
              f"run_bm5d {p_s:.3f} dB (delta {p_b - p_s:+.4f})")
        if p_b < PSNR_FINAL_MIN or abs(p_b - p_s) > BATCH_PSNR_DELTA_MAX:
            raise AssertionError(f"denoise_batch, noise seed {seed}: final "
                                 f"PSNR {p_b:.3f} vs run_bm5d {p_s:.3f}")


def png_codec():
    """The PNG codec lf.io will use here: (name, None), or (None, what is
    missing) when no codec exists."""
    from lfbm5d_torch import native

    if native.available():
        return "native libpng (lfbm5d_torch/native)", None
    have = []
    for mod in ("cv2", "PIL"):
        try:
            __import__(mod)
            have.append(mod)
        except ImportError:
            pass
    lines = native.unavailable_reason().splitlines()
    why = next((ln for ln in lines if "error" in ln), lines[0])
    if "PIL" not in have:
        return None, f"PIL, and the native codec is unavailable ({why})"
    return (f"{'OpenCV read, ' if 'cv2' in have else 'PIL read, '}PIL write "
            f"(the native codec is unavailable: {why})"), None


def phase_disk(kernels, path, params, clean, noisy):
    """(o): the three flagship LFs written as PNG SAIs, streamed disk to
    disk by stream_denoise_dirs, read back (final PSNR >= PSNR_FINAL_MIN);
    then the CLI on the first of them in a subprocess."""
    import numpy as np

    from lfbm5d_torch import psnr_device
    from lfbm5d_torch.lf.io import load_lf, save_lf
    from lfbm5d_torch.pipeline.stream_io import stream_denoise_dirs

    a_h, a_w = np.shape(clean)[:2]
    codec, missing = png_codec()
    if codec is None:
        print(f"(o) no PNG codec on this machine: missing {missing}; the "
              f"disk phase is not run")
        return
    pat = "SAI_%02d_%02d.png"
    root = tempfile.mkdtemp(prefix="smoke_o_", dir=os.path.join(REPO,
                                                                "build"))
    try:
        t0 = time.perf_counter()
        jobs = []
        for seed, lf in zip(BATCH_NOISE_SEEDS, noisy):
            d = os.path.join(root, f"noisy_{seed}")
            save_lf(lf, d, pat)
            jobs.append((d, os.path.join(root, f"final_{seed}")))
        print(f"(o) PNG codec: {codec}; 3 noisy flagship LFs written in "
              f"{time.perf_counter() - t0:.1f} s")
        report, _ = drive("(o)", kernels, path,
                          lambda: stream_denoise_dirs(jobs, params, a_h, a_w))
        n = len(jobs)
        print(f"(o) stream_denoise_dirs: {report.n_done} done, "
              f"{report.n_failed} failed; {report.seconds_total:.3f} s = "
              f"{report.seconds_total / n:.4f} s/LF; seconds_device / "
              f"seconds_total {report.seconds_device:.3f} / "
              f"{report.seconds_total:.3f} = "
              f"{report.seconds_device / report.seconds_total:.3f}; per LF "
              f"{[round(s, 3) for s in report.lf_seconds]}")
        if report.n_done != n or report.n_failed:
            raise AssertionError(f"stream_denoise_dirs: {report.failures}")
        for seed, (_, out) in zip(BATCH_NOISE_SEEDS, jobs):
            back = load_lf(out, pat, a_h, a_w)
            p = psnr_device(back, clean)
            print(f"(o) noise seed {seed}: final PSNR of the PNGs read back "
                  f"{p:.3f} dB")
            if back.shape != clean.shape or p < PSNR_FINAL_MIN:
                raise AssertionError(f"disk stream, noise seed {seed}: "
                                     f"final PSNR {p:.3f}")
        out = os.path.join(root, "cli")
        cmd = [sys.executable, "-m", "lfbm5d_torch.cli", "denoise",
               "--input", jobs[0][0], "--aheight", str(a_h), "--awidth",
               str(a_w),
               "--sigma", "25", "--preset", "matched", "--output", out,
               "--json"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            raise AssertionError(f"the CLI failed ({res.returncode}):\n"
                                 f"{res.stderr[-3000:]}")
        rep = json.loads(res.stdout.strip().splitlines()[-1])
        p = psnr_device(load_lf(out, pat, a_h, a_w), clean)
        print(f"(o) python -m lfbm5d_torch.cli denoise --preset matched "
              f"--json (subprocess, {time.perf_counter() - t0:.1f} s): "
              f"preset {rep.get('preset_selected', 'matched')}, "
              f"seconds_denoise {rep['seconds_denoise']}, seconds_load "
              f"{rep['seconds_load']}, seconds_save {rep['seconds_save']}; "
              f"final PSNR of its PNGs {p:.3f} dB")
        if rep["shape"] != list(np.shape(clean)) or p < PSNR_FINAL_MIN:
            raise AssertionError(f"the CLI's output: final PSNR {p:.3f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_row(kernels, path, argv):
    """(r): the bench's main on argv in process, under drive: (its JSON
    last line, checked for the keys, finite PSNRs, a null vs_baseline and
    the card's name; the launch counts)."""
    import contextlib
    import io

    import torch

    from lfbm5d_torch import bench

    def run():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(argv)
        return rc, buf.getvalue()

    label = f"(r) {' '.join(argv) or '(no flags)'}"
    (rc, out), counts = drive(label, kernels, path, run)
    row = json.loads(out.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in row]
    if rc != 0 or missing:
        raise AssertionError(f"{label}: exit {rc}, keys missing {missing}")
    sel = (f", selected {row['adaptive_selected']}"
           if "adaptive_selected" in row else "")
    print(f"{label}: {row['seconds_per_lf']:.4f} s/LF = {row['value']:.3f} "
          f"Mpix/s, runs {row['run_seconds']}, spread {row['spread_frac']}, "
          f"first run {row['compile_plus_first_s']} s; PSNR noisy / basic / "
          f"final {row['psnr_noisy_db']} / {row['psnr_basic_db']} / "
          f"{row['psnr_final_db']} dB; preset {row['preset']}{sel}, engine "
          f"{row['engine']}, device {row['device']}")
    dbs = [row[k] for k in ("psnr_noisy_db", "psnr_basic_db",
                            "psnr_final_db")]
    if (not all(math.isfinite(d) for d in dbs) or dbs[2] <= dbs[0]
            or row["vs_baseline"] is not None
            or row["device"]["name"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"{label}: PSNRs {dbs}, vs_baseline "
                             f"{row['vs_baseline']}, device {row['device']}")
    return row, counts


def phase_bench(kernels, bm_path, d_final, d_dt):
    """(r): the bench's rows in process, then `python -m
    lfbm5d_torch.bench --quick` in a subprocess."""
    import torch

    from lfbm5d_torch import bench

    t_phase = time.perf_counter()
    f32_path = bm_path + ["fused_group_step"]
    row, counts = bench_row(kernels, f32_path, [])
    want = 18 * (1 + bench.parse([]).runs)
    print(f"(r) headline {row['seconds_per_lf']:.4f} s/LF beside (d)'s "
          f"timed run {d_dt:.4f} s/LF (ratio "
          f"{row['seconds_per_lf'] / d_dt:.3f}); final PSNR "
          f"{row['psnr_final_db']:.4f} beside (d)'s {d_final:.4f} dB")
    if any(counts[n] != want for n in f32_path):
        raise AssertionError(f"(r) headline: launches "
                             f"{ {n: counts[n] for n in f32_path} }, "
                             f"{want} expected (18 per run)")
    if (row["psnr_final_db"] < PSNR_FINAL_MIN
            or row["psnr_basic_db"] < PSNR_BASIC_MIN):
        raise AssertionError(f"(r) headline PSNR below the record: "
                             f"{row['psnr_basic_db']}, "
                             f"{row['psnr_final_db']}")
    if row["seconds_per_lf"] > BENCH_DT_RATIO_MAX * d_dt:
        raise AssertionError(f"(r) headline {row['seconds_per_lf']:.4f} "
                             f"s/LF over {BENCH_DT_RATIO_MAX} x (d)'s "
                             f"{d_dt:.4f}")
    for argv in (["--quick"], ["--proxy"]):
        bench_row(kernels, f32_path, argv)
    row, _ = bench_row(kernels, f32_path, ["--preset", "adaptive"])
    if row["adaptive_selected"] != "matched":
        raise AssertionError(f"(r) adaptive: {row['adaptive_selected']} on "
                             f"the two-plane LF")
    _, counts = bench_row(kernels, bm_path + ["fused_group_step_bf16"],
                          ["--engine", "pallas_bf16", "--runs", "1"])
    if counts["fused_group_step"]:
        raise AssertionError("(r) pallas_bf16 launched the f32 group kernel")
    root = tempfile.mkdtemp(prefix="smoke_r_", dir=os.path.join(REPO,
                                                                "build"))
    try:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "lfbm5d_torch.bench",
                              "--quick", "--profile", root], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise AssertionError(f"(r) the bench's subprocess failed "
                                 f"({res.returncode}):\n"
                                 f"{res.stderr[-3000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        top = res.stderr[res.stderr.find("device self-time total"):]
        print(f"(r) python -m lfbm5d_torch.bench --quick --profile DIR "
              f"(subprocess, {time.perf_counter() - t0:.1f} s): "
              f"{row['seconds_per_lf']:.4f} s/LF, first run "
              f"{row['compile_plus_first_s']:.2f} s, final PSNR "
              f"{row['psnr_final_db']:.4f} dB, device {row['device']}; its "
              f"top ops:\n{top.rstrip()}")
        if row["device"]["name"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"(r) the subprocess ran on "
                                 f"{row['device']}")
        if (not top or os.path.getsize(os.path.join(root, "trace.json"))
                == 0):
            raise AssertionError("(r) --profile wrote no trace or no top "
                                 "ops")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"(r) took {time.perf_counter() - t_phase:.1f} s")


def drive(label, kernels, path, fn):
    """Run one path with every launch count zeroed just before; the counts
    just after. Fails if a kernel of the path never launched."""
    for f in kernels.values():
        f.launches = 0
    out = fn()
    launches = {name: f.launches for name, f in kernels.items()}
    ran = {name: launches[name] for name in path}
    print(f"{label} launches {launches}")
    if min(ran.values()) <= 0:
        raise AssertionError(f"{label}: a kernel of the path never ran: "
                             f"{ran}")
    return out, launches


def in_turns(label, fn, libs, outs):
    """fn(lib, out) of the parent (libs[0]) and this tree (libs[1]) in turns
    parent, new, new, parent, 5 launches each: (parent ms, new ms)."""
    ms = [cuda_ms(lambda i=i: fn(libs[i], outs[i])) for i in (0, 1, 1, 0)]
    p_ms, n_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    print(f"ab {label}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, new "
          f"{ms[1]:.4f} / {ms[2]:.4f} ms, parent/new {p_ms / n_ms:.2f}x")
    return p_ms, n_ms


def ab_two_kernel(libs, params, x, sigma_c):
    """--ab at (e)'s table shape (17x17x128x128, reference SAI 0, matched
    HT): the two trees' extract kernels must write equal group tensors and
    their fused accumulate kernels agree within ACC_REL_MAX."""
    import torch

    from lfbm5d_torch.kernels import _build

    sp = params.ht
    k, nd = sp.k, sp.n_disp
    pl, (bidx, sy, sx, mask, r), _, kai = two_kernel_case(
        sp, params.lambda_3d, x, sigma_c)
    p, a, hp, wp = pl.shape
    g, n = sy.shape
    stream = _build.stream_of(pl)
    geo = (bidx.data_ptr(), None, sy.data_ptr(), sx.data_ptr(),
           mask.data_ptr())
    dims = (g * n, p, a, hp, wp, hp - k + 1, wp - k + 1, k, nd, r, stream)

    def extract_on(lib, out):
        _build.check(lib.lfbm5d_extract_groups(pl.data_ptr(), *geo,
                                               out.data_ptr(), *dims),
                     "extract_groups")

    groups = [torch.empty((p, g, n, k * k, a), device=pl.device)
              for _ in range(2)]
    for lib, out in zip(libs, groups):
        extract_on(lib, out)
    torch.cuda.synchronize()
    equal = bool(torch.equal(*groups))
    gen = torch.Generator(device=pl.device).manual_seed(0)
    wv = torch.rand((p, g, n), device=pl.device, generator=gen) * mask[None]
    vals = groups[1] * (wv[..., None, None] * kai[:, None])

    def accumulate_on(lib, acc):
        _build.check(lib.lfbm5d_accumulate_groups(
            vals.data_ptr(), wv.data_ptr(), kai.data_ptr(), bidx.data_ptr(),
            *geo[1:], acc[0].data_ptr(), acc[1].data_ptr(), *dims),
            "accumulate_groups")

    accs = [(torch.zeros_like(pl), torch.zeros_like(pl)) for _ in range(2)]
    for lib, acc in zip(libs, accs):
        accumulate_on(lib, acc)
    rel = max(_rel(accs[1][i], accs[0][i]) for i in (0, 1))
    label = f"17x17x128x128 (k={k}, nd={nd}, A={a}, S={g * n})"
    in_turns(f"{label} extract_groups (outputs equal {equal})", extract_on,
             libs, groups)
    in_turns(f"{label} accumulate_groups_fused (rel {rel:.2e})",
             accumulate_on, libs, accs)
    if not equal or rel > ACC_REL_MAX:
        raise AssertionError("the parent's and this tree's two-kernel "
                             "kernels disagree")


def ab_gather(libs, params, x, sigma_c):
    """--ab at (j)'s flagship shape: the two trees' row-gather kernels must
    write equal outputs (and equal index_select's); the parent's kernel, this
    tree's, index_select and a copy of the output's size timed in turns on a
    cold L2 (cuda_ms_cold)."""
    import torch

    from lfbm5d_torch.kernels import _build

    table, rows = gather_case(params, x, sigma_c)[4:]
    n, w = rows.numel(), table.shape[1]
    stream = _build.stream_of(table)
    outs = [torch.empty((n, w), dtype=table.dtype, device=table.device)
            for _ in range(2)]

    def on(lib, out):
        _build.check(lib.lfbm5d_gather_rows(table.data_ptr(), rows.data_ptr(),
                                            out.data_ptr(), n, w, stream),
                     "gather_rows")

    rows_l = rows.long()
    for lib, out in zip(libs, outs):
        on(lib, out)
    want = table.index_select(0, rows_l)
    equal = all(bool(torch.equal(o, want)) for o in outs)
    src, dst = torch.ones_like(want), torch.empty_like(want)
    (p_ms, plo, phi), (n_ms, nlo, nhi), (l_ms, llo, lhi), (c_ms, clo, chi) = \
        cold_rounds((lambda: on(libs[0], outs[0]),
                     lambda: on(libs[1], outs[1]),
                     lambda: table.index_select(0, rows_l),
                     lambda: dst.copy_(src)))
    print(f"ab gather_rows S={n}, W={w} (outputs equal {equal}), cold L2, "
          f"{GATHER_ROUNDS} rounds in turns: parent median {p_ms:.4f} ms "
          f"(min {plo:.4f}, max {phi:.4f}), new median {n_ms:.4f} ms (min "
          f"{nlo:.4f}, max {nhi:.4f}), index_select median {l_ms:.4f} ms "
          f"(min {llo:.4f}, max {lhi:.4f}), copy_ of the output's size "
          f"median {c_ms:.4f} ms (min {clo:.4f}, max {chi:.4f}); parent/new "
          f"{p_ms / n_ms:.2f}x, index_select/new {l_ms / n_ms:.2f}x; new "
          f"{'no slower' if n_ms <= l_ms else 'SLOWER'} than index_select")
    if not equal:
        raise AssertionError("the parent's and this tree's gather_rows "
                             "disagree")


def ab_groups(libs, m, sig) -> None:
    """--ab: both trees' group kernels (lfbm5d_group_step at the flagship's
    reference 0, lfbm5d_group_step_banked at 9x9x64x96 `default`), both
    chains, HT and Wiener, on the same BM outputs and tables: outputs
    within GROUP_BF16_REL_MAX (bf16) / GROUP_REL_MAX (f32) relative L2 of
    each other, times in turns, and per chain HT + Wiener summed with the
    ratio new / parent."""
    import torch

    from lfbm5d_torch import preset_denoise_params

    for label, preset, side, h, w, banked in CLOCK_CASES:
        params = preset_denoise_params(preset, 25.0, chunk=128)
        noisy, clean = lf_on_card(side, h, w, 1)
        x, basic_w = noisy @ m.T, clean @ m.T
        sums = {}
        for basic, wiener in ((None, False), (basic_w, True)):
            for chain in (None, torch.bfloat16):
                bf16 = chain is not None
                g = group_setup(params, x, basic, sig, wiener, chain)
                outs = []
                for lib in libs:
                    raw_group_step(lib, g, banked, bf16)
                    outs.append((g["num"].clone(), g["wden"].clone()))
                rel = max(_rel(outs[1][i], outs[0][i]) for i in (0, 1))
                tag = "bf16" if bf16 else "f32"
                p_ms, n_ms = in_turns(
                    f"{label} {'Wiener' if wiener else 'HT'} {tag} group "
                    f"kernel (rel {rel:.2e})",
                    lambda lib, _o: raw_group_step(lib, g, banked, bf16),
                    libs, (None, None))
                old_ms, new_ms = sums.get(tag, (0.0, 0.0))
                sums[tag] = (old_ms + p_ms, new_ms + n_ms)
                if rel > (GROUP_BF16_REL_MAX if bf16 else GROUP_REL_MAX):
                    raise AssertionError(f"{label} {tag}: the parent's and "
                                         f"this tree's group kernels disagree")
                del g, outs
        for tag, (p_ms, n_ms) in sums.items():
            print(f"ab {label} {tag} group kernels, HT + Wiener: parent "
                  f"{p_ms:.3f} ms, new {n_ms:.3f} ms, new/parent "
                  f"{n_ms / p_ms:.3f}x")
        print(f"ab {label}: bf16/f32 new {sums['bf16'][1] / sums['f32'][1]:.3f}"
              f"x, parent {sums['bf16'][0] / sums['f32'][0]:.3f}x")
        del noisy, clean, x, basic_w


# --swap-check: the f32 slice column of csrc/group_stage.cuh's scatter and
# fetch, and a mutant that decodes SAI a = s*aW + t transposed
SLICE_COLUMN = "(a / p.aW) * awp + a % p.aW"
SLICE_COLUMN_SWAPPED = "(a % p.aH) * awp + a / p.aH"
# (aH, aW, banked) at 32x48 `matched`: square controls, then (q)'s grids
SWAP_CASES = ((9, 9, False), (5, 7, False), (7, 5, False), (11, 11, True),
              (8, 16, True))


def swap_check() -> int:
    """--swap-check: whether (q)'s comparison sees an s/t swap that every
    square check passes. Two mutants, each made outside the checkout: the
    sources of lfbm5d_torch/csrc copied to a temporary directory with the
    f32 slice column decoded transposed (SLICE_COLUMN_SWAPPED), built; and
    the bf16 chain's dense angular table built for the swapped s/t order
    (kernels/fused.py::dense_tables patched in memory). Each mutant group
    kernel against the plain version at SWAP_CASES (reference SAI as (q)),
    HT and Wiener: 0 if every square grid stays within (c)'s / (p)'s bound
    and every non-square one falls outside it, else 1."""
    import tempfile
    from pathlib import Path

    import torch

    from lfbm5d_torch import preset_denoise_params
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.kernels import fused as kf
    from lfbm5d_torch.lf import color_matrix
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    print(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "csrc"
        shutil.copytree(Path(REPO) / "lfbm5d_torch" / "csrc", src)
        gs = src / "group_stage.cuh"
        text = gs.read_text()
        if text.count(SLICE_COLUMN) != 2:
            raise AssertionError("group_stage.cuh's slice column changed: "
                                 "update SLICE_COLUMN")
        gs.write_text(text.replace(SLICE_COLUMN, SLICE_COLUMN_SWAPPED))
        lib = _build.load(_build.build(src))
    dev = torch.device("cuda:0")
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    sig = _sigma(dev)
    dense = kf.dense_tables

    def swapped(a_h, a_w):
        perm = torch.arange(a_h * a_w, device=dev).view(a_h, a_w).t()
        p = perm.reshape(-1)
        return lambda f4, i4: dense(f4[p][:, p], i4[p][:, p])

    pp = preset_denoise_params("matched", 25.0)
    wrong = []
    for a_h, a_w, banked in SWAP_CASES:
        noisy, clean = lf_on_card(a_h, 32, 48, 1, dev, a_w)
        x, guide = noisy @ m.T, clean @ m.T
        ref = interior_ref(a_h, a_w)
        for bf16 in (False, True):
            for basic, wiener in ((None, False), (guide, True)):
                build_kernel_step.cache_clear()
                if bf16:  # the plain version reads gt, not the dense table
                    kf.dense_tables = swapped(a_h, a_w)
                try:
                    g = group_setup(pp, x, basic, sig, wiener,
                                    torch.bfloat16 if bf16 else None, ref)
                finally:
                    kf.dense_tables = dense
                    build_kernel_step.cache_clear()
                raw_group_step(lib, g, banked, bf16)
                nk, dk = g["num"].clone(), g["wden"].clone()
                g["run"](kf.fused_group_step_plain)
                rel = max(_rel(nk, g["num"]), _rel(dk, g["wden"]))
                bound = GROUP_BF16_REL_MAX if bf16 else GROUP_REL_MAX
                label = (f"{'bf16 dense table' if bf16 else 'f32 slice'} "
                         f"{a_h}x{a_w}x32x48 matched "
                         f"{'banked' if banked else 'fused'} "
                         f"{'Wiener' if wiener else 'HT'}")
                print(f"swap-check mutant {label}: rel {rel:.2e} "
                      f"({'inside' if rel <= bound else 'outside'} {bound})")
                if (rel <= bound) != (a_h == a_w):
                    wrong.append(label)
        del noisy, clean, x, guide
    if wrong:
        print(f"swap-check: on the wrong side of the bound: {wrong}")
        return 1
    print("swap-check: every square grid inside its bound, every non-square "
          "one outside")
    return 0


def ab(parent_dir: str) -> int:
    """--ab PARENT: the parent tree's kernels (its lfbm5d_torch/csrc built
    apart; the same C entry points) against this tree's, on the same inputs
    and preallocated outputs, in turns (`in_turns`): the two BM kernels at
    (b)'s four shapes, outputs equal; both group kernels in both chains
    (`ab_groups`); extract and fused accumulate at (e)'s table shape
    (`ab_two_kernel`); the row gather (`ab_gather`)."""
    import ctypes
    from pathlib import Path

    import torch

    from lfbm5d_torch import preset_denoise_params
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.lf import color_matrix
    from lfbm5d_torch.ops.distances import DIST_QUANT

    print(card_line())
    lib = _build.library()
    new_seconds = dict(_build.source_seconds)
    print_ptxas(_build.build_log, "new")
    plib = ctypes.CDLL(str(_build.build(Path(parent_dir) / "lfbm5d_torch"
                                        / "csrc")))
    plib.lfbm5d_error_string.argtypes = [ctypes.c_int]
    plib.lfbm5d_error_string.restype = ctypes.c_char_p
    print_ptxas(_build.build_log, "parent")
    print("nvcc seconds per source, this tree: " + ", ".join(
        f"{k} {v:.1f}" for k, v in new_seconds.items()) + "; parent: " +
        ", ".join(f"{k} {v:.1f}" for k, v in _build.source_seconds.items()))
    for name in ("lfbm5d_self_distances", "lfbm5d_cross_argmin",
                 "lfbm5d_group_step", "lfbm5d_group_step_banked",
                 "lfbm5d_extract_groups", "lfbm5d_accumulate_groups",
                 "lfbm5d_gather_rows"):
        getattr(plib, name).argtypes = _build._SIGNATURES[name]
    libs = (plib, lib)
    dev = torch.device("cuda:0")
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    x17 = lf_on_card(17, 128, 128, 100)[0] @ m.T
    x_flag = lf_on_card(9, 434, 625, 1)[0] @ m.T
    cases = bm_cases(x_flag, x17)
    for label, ctx in cases:
        sp, match0 = ctx["sp"], ctx["match0"]
        k, n, nd = sp.k, sp.n_search, sp.n_disp
        a, hp, wp = match0.shape
        plane = match0[ctx["ref"]]
        ys = torch.as_tensor(ctx["ys"], dtype=torch.int32, device=dev)
        xs = torch.as_tensor(ctx["xs"], dtype=torch.int32, device=dev)
        scale = DIST_QUANT / (k * k)
        stream = _build.stream_of(plane)
        dk = [torch.empty((len(ys) * len(xs), (2 * n + 1) ** 2),
                          dtype=torch.int32, device=dev) for _ in range(2)]
        bk = [torch.empty((a, hp - k + 1, wp - k + 1), dtype=torch.int32,
                          device=dev) for _ in range(2)]

        def self_on(L, out):
            _build.check(L.lfbm5d_self_distances(
                plane.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                out.data_ptr(), hp, wp, len(ys), len(xs), k, n, scale,
                stream), "self_distances")

        def cross_on(L, out):
            _build.check(L.lfbm5d_cross_argmin(
                plane.data_ptr(), match0.data_ptr(), out.data_ptr(), a, hp,
                wp, k, nd, scale, stream), "cross_argmin")

        for name, fn, outs in (("self_distances", self_on, dk),
                               ("cross_argmin", cross_on, bk)):
            for L, o in zip(libs, outs):
                fn(L, o)
            torch.cuda.synchronize()
            equal = bool(torch.equal(outs[0], outs[1]))
            in_turns(f"{label} {name} (k={k}, n={n}, nd={nd}, A={a}; "
                     f"outputs equal {equal})", fn, libs, outs)
            if not equal:
                raise AssertionError(f"{name} ({label}): the parent's and "
                                     f"this tree's outputs differ")
    ab_groups(libs, m, _sigma(dev))
    params = preset_denoise_params("matched", 25.0, chunk=128)
    ab_two_kernel(libs, params, x17, _sigma(dev))
    ab_gather(libs, params, x_flag, _sigma(dev))
    return 0


def _sigma(dev):
    """Per-channel sigma of the OPP planes at sigma 25."""
    from lfbm5d_torch.pipeline.denoise import _sigma_channels

    return _sigma_channels(25.0, "opp", 3, "float32", dev)


def phase_clocks() -> None:
    """--profile `counters`: the group kernels of the counter build
    (_build.library(clocks=True), csrc/group_stage.cuh's PHASE marks) at
    the flagship's reference 0 (fused) and 9x9x64x96 `default` reference 0
    (banked), HT and Wiener, f32 and bf16 chains: thread 0's cycles per
    phase summed over the CTAs, as shares of the CTAs' cycles and per
    (group, channel) step of a CTA. Five launches each after one warm
    launch (counters reset between)."""
    import ctypes

    import torch

    from lfbm5d_torch import preset_denoise_params
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.lf import color_matrix

    t0 = time.perf_counter()
    lib = _build.library(clocks=True)
    print(f"counters: counter build loaded in {time.perf_counter() - t0:.1f}"
          f" s")
    print_ptxas(_build.build_log, "counters")
    dev = torch.device("cuda:0")
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    sig = _sigma(dev)
    out = (ctypes.c_uint64 * (len(PHASE_NAMES) + 2))()
    for label, preset, side, h, w, banked in CLOCK_CASES:
        params = preset_denoise_params(preset, 25.0, chunk=128)
        noisy, clean = lf_on_card(side, h, w, 1)
        x = noisy @ m.T
        basic_w = clean @ m.T  # the Wiener guide: the clean LF, as (c)
        read = lib.lfbm5d_group_clocks_banked if banked else \
            lib.lfbm5d_group_clocks
        for basic, wiener in ((None, False), (basic_w, True)):
            for chain in (None, torch.bfloat16):
                g = group_setup(params, x, basic, sig, wiener, chain)
                bf16 = chain is not None
                raw_group_step(lib, g, banked, bf16)
                _build.check(read(out, 1), "phase clocks")
                reps = 5
                for _ in range(reps):
                    raw_group_step(lib, g, banked, bf16)
                _build.check(read(out, 1), "phase clocks")
                cyc = list(out)
                total = sum(cyc[:len(PHASE_NAMES)])
                steps = max(cyc[len(PHASE_NAMES)], 1)
                print(f"counters {label} {'Wiener' if wiener else 'HT'} "
                      f"{'bf16' if bf16 else 'f32'} "
                      f"({'banked' if banked else 'fused'}): "
                      f"{steps // reps} (group, channel) steps over the CTAs"
                      f" per launch, {total / steps:.0f} cycles per step of "
                      f"a CTA (CTA lifetime {cyc[-1] / steps:.0f})")
                print("  " + "; ".join(
                    f"{n} {c / total:.1%} ({c / steps:.0f})"
                    for n, c in zip(PHASE_NAMES, cyc)))
                del g
        del noisy, clean, x, basic_w


def profile(names) -> None:
    """Device time by kernel group of one warm run per cell; the cell
    `counters` runs phase_clocks instead."""
    import torch

    from lfbm5d_torch import preset_denoise_params

    print(card_line())
    if "counters" in names:
        phase_clocks()
        names = [n for n in names if n != "counters"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name in names:
        a, h, w, noise_seed, preset, fused, mode = CELLS[name]
        if noise_seed is None:
            lr, _, sr_params = sr_flagship(a, h, w)

            def run():
                return timed_sr(lr, sr_params)[1]
        else:
            params = preset_denoise_params(preset, 25.0)
            noisy = lf_on_card(a, h, w, noise_seed)[0]

            def run():
                return timed_run(noisy, params, fused=fused,
                                 doff_mode=mode)[1]
        run()
        with torch.profiler.profile(activities=acts) as prof:
            wall = run()
        by_group, launches = {}, {}
        for ev in prof.key_averages():
            if (ev.self_device_time_total <= 0
                    or ev.device_type != torch.autograd.DeviceType.CUDA):
                continue
            g = next((grp for frag, grp in KERNEL_GROUPS
                      if frag in ev.key.lower()), "torch elementwise, copies")
            by_group[g] = by_group.get(g, 0.0) + ev.self_device_time_total / 1e3
            launches[g] = launches.get(g, 0) + ev.count
        busy = sum(by_group.values())
        print(f"cell {name} ({a}x{a}x{h}x{w} RGB, {preset}, fused={fused}, "
              f"doff_mode={mode}{', SR x2' if noise_seed is None else ''}): "
              f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
              f"share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
        for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {ms:.2f} ms ({ms / busy:.1%}), {launches[g]} "
                  f"launches")
        del run


def main(argv) -> int:
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
    # the plain versions are the references: full-precision f32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--profile"]:
        profile(argv[1].split(",") if len(argv) > 1
                else list(CELLS) + ["counters"])
        return 0
    if argv[:1] == ["--swap-check"]:
        return swap_check()
    if argv[:1] == ["--ab"] and len(argv) == 2:
        return ab(argv[1])
    from lfbm5d_torch import preset_denoise_params, psnr_device, run_bm5d
    from lfbm5d_torch.kernels import _build
    from lfbm5d_torch.kernels.accumulate import (
        accumulate_groups, accumulate_groups_fused,
    )
    from lfbm5d_torch.kernels.bm import (
        cross_argmin_all_kernel, self_distances_kernel,
    )
    from lfbm5d_torch.kernels.extract import extract_groups
    from lfbm5d_torch.kernels.fused import (
        fused_group_step, fused_group_step_banked,
        fused_group_step_banked_bf16, fused_group_step_bf16,
        group_smem_bytes,
    )
    from lfbm5d_torch.kernels.gather import gather_rows
    from lfbm5d_torch.lf import (
        add_noise_np, color_matrix, synthetic_lf,
    )
    from lfbm5d_torch.pipeline.denoise import ht_step
    from lfbm5d_torch.pipeline.engine import build_kernel_step

    kernels = {
        "self_distances_kernel": self_distances_kernel,
        "cross_argmin_all_kernel": cross_argmin_all_kernel,
        "fused_group_step": fused_group_step,
        "fused_group_step_banked": fused_group_step_banked,
        "fused_group_step_bf16": fused_group_step_bf16,
        "fused_group_step_banked_bf16": fused_group_step_banked_bf16,
        "extract_groups": extract_groups,
        "accumulate_groups_fused": accumulate_groups_fused,
        "accumulate_groups": accumulate_groups,
        "gather_rows": gather_rows,
    }
    bm_path = ["self_distances_kernel", "cross_argmin_all_kernel"]
    dev = torch.device("cuda:0")
    m = torch.as_tensor(color_matrix("opp"), dtype=torch.float32, device=dev)
    sig = _sigma(dev)

    phase = "(a)"
    launches = {}  # kernel -> launches on the path it serves
    try:
        card = card_line()
        print(f"(a) card: {card}")
        print(f"(a) python {sys.version.split()[0]}, torch {torch.__version__}"
              f", CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        lib = _build.library()
        nvcc_s = _build.build_seconds
        print(f"(a) kernels built and loaded in "
              f"{time.perf_counter() - t0:.1f} s (nvcc: "
              f"{'cached' if nvcc_s is None else f'{nvcc_s:.1f} s'})")
        if _build.source_seconds:
            print("(a) nvcc seconds per source (in parallel): " + ", ".join(
                f"{k} {v:.1f}" for k, v in _build.source_seconds.items()))
        print_ptxas(_build.build_log, "(a)")
        if _build.build_log:
            check_bf16_spills(_build.build_log, "(a)")
        else:
            print("(a) the library was built by an earlier run: no ptxas "
                  "report to check for spills")
        plan_table(lib)
        bm_plan_table(lib)
        twokernel_plan_table(lib)
        params = preset_denoise_params("matched", 25.0, chunk=128)
        gather_plan_table(lib, params)

        phase = "(b)"
        noisy_dev, clean_dev = lf_on_card(9, 434, 625, 1)
        x = noisy_dev @ m.T
        mid, mid_clean = lf_on_card(17, 128, 128, 100)
        xm = mid @ m.T
        rows = {}
        for label, ctx in bm_cases(x, xm):
            out = phase_bm(f"(b) {label}", ctx)
            if not rows:  # the matched flagship: the kernels line's rows
                rows = out
            del ctx

        phase = "(c)"
        small = lf_on_card(9, 64, 96, 1)[0] @ m.T
        small_basic = ht_step(small, 25.0, params.ht, params.lambda_3d,
                              "opp", engine="auto", device=dev)
        for basic, wiener in ((None, False), (small_basic, True)):
            group_check("(c) 9x9x64x96", params, small, basic, sig, wiener,
                        "fused_group_step", lib)
        pilot = clean_dev @ m.T
        checks = [group_check("(c) flagship", params, x, basic, sig, wiener,
                              "fused_group_step", lib)
                  for basic, wiener in ((None, False), (pilot, True))]
        rows["fused_group_step"] = dict(
            max_abs_err=max(r[0] for r in checks),
            ms=sum(r[1] for r in checks), plain_ms=sum(r[2] for r in checks),
            bound_ms=sum(r[3] for r in checks), bound_by=checks[0][4])

        phase = "(d)"
        fused_path = bm_path + ["fused_group_step"]
        t0 = time.perf_counter()
        run_bm5d(noisy_dev, params, engine="auto")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ((basic, final), dt), counts = drive(
            "(d)", kernels, fused_path, lambda: timed_run(noisy_dev, params))
        launches.update({n: counts[n] for n in fused_path})
        peak = torch.cuda.max_memory_allocated()
        if tuple(final.shape) != tuple(noisy_dev.shape) or not bool(
                torch.isfinite(final).all() & torch.isfinite(basic).all()):
            raise AssertionError("flagship output has the wrong shape or "
                                 "non-finite values")
        p_noisy = psnr_device(noisy_dev, clean_dev)
        p_basic = psnr_device(basic, clean_dev)
        p_final = psnr_device(final, clean_dev)
        mpix = 9 * 9 * 434 * 625 / 1e6
        print(f"(d) flagship 9x9x434x625 RGB matched: warm run {warm:.3f} s, "
              f"timed run {dt:.4f} s/LF = {mpix / dt:.3f} Mpix/s")
        print(f"(d) PSNR noisy {p_noisy:.3f} / basic {p_basic:.3f} / final "
              f"{p_final:.3f} dB; peak device memory {peak / 2**30:.2f} GiB")
        if p_final < PSNR_FINAL_MIN or p_basic < PSNR_BASIC_MIN:
            raise AssertionError(f"flagship PSNR below the record: basic "
                                 f"{p_basic:.3f}, final {p_final:.3f}")
        d_final, d_dt = p_final, dt
        del noisy_dev, clean_dev, x, pilot, basic, final

        tiny = add_noise_np(synthetic_lf(3, 3, 32, 40, channels=3, seed=8),
                            25.0, seed=9)
        tclean = synthetic_lf(3, 3, 32, 40, channels=3, seed=8)
        _, f_gpu = run_bm5d(tiny, params, engine="auto", device=dev)
        _, f_ref = run_bm5d(tiny, params, dtype="float64", engine="torch",
                            device="cpu")
        d_ps = psnr_device(f_gpu, tclean) - psnr_device(f_ref, tclean)
        d_max = float((f_gpu.cpu().double() - f_ref).abs().max())
        print(f"(d) 3x3x32x40 RGB kernels (f32, GPU) vs plain f64 (CPU): "
              f"PSNR delta {d_ps:+.4f} dB, max |d| {d_max:.3e}")
        if abs(d_ps) > PSNR_DELTA_MAX:
            raise AssertionError("small LF disagrees with the f64 reference")

        phase = "(e)"
        for n_sim, a in ((8, 9), (8, 17), (16, 9), (16, 19), (4, 3)):
            py = group_smem_bytes(n_sim, a * a, a, a)
            c_ = lib.lfbm5d_group_smem_bytes(n_sim, a * a, a, a)
            if py != c_:
                raise AssertionError(f"group_smem_bytes({n_sim}, {a}x{a}): "
                                     f"Python {py} vs library {c_}")
        print("(e) group_smem_bytes: Python copy == library at 5 shapes")
        x17 = lf_on_card(17, 32, 32, 1)[0] @ m.T
        for basic, wiener in ((None, False), (x17 + 0.5, True)):
            group_check("(e) 17x17x32x32 matched", params, x17, basic, sig,
                        wiener, "fused_group_step_banked", lib)
        dflt = preset_denoise_params("default", 25.0)
        for basic, wiener in ((None, False), (small_basic, True)):
            group_check("(e) 9x9x64x96 default", dflt, small, basic, sig,
                        wiener, "fused_group_step_banked", lib)
        # N=16 at 17x17 and 19x19: the shapes that need clusters of 16
        x19 = lf_on_card(19, 32, 32, 1)[0] @ m.T
        for lf, name in ((x17, "17x17x32x32"), (x19, "19x19x32x32")):
            for basic, wiener in ((None, False), (lf + 0.5, True)):
                group_check(f"(e) {name} default", dflt, lf, basic, sig,
                            wiener, "fused_group_step_banked", lib)
        del x19
        checks = [group_check("(e) 17x17x128x128 matched", params, xm, basic,
                              sig, wiener, "fused_group_step_banked", lib)
                  for basic, wiener in ((None, False), (xm + 0.5, True))]
        rows["fused_group_step_banked"] = dict(
            max_abs_err=max(r[0] for r in checks),
            ms=sum(r[1] for r in checks), plain_ms=sum(r[2] for r in checks),
            bound_ms=sum(r[3] for r in checks), bound_by=checks[0][4])
        rows.update(two_kernel_checks(params, xm, sig))
        t0 = time.perf_counter()
        big, big_clean = lf_on_card(17, 512, 512, 100)
        print(f"(e) 17x17x512x512 RGB made in {time.perf_counter() - t0:.1f} "
              f"s (host)")
        two_kernel_shapes(params, x17, big @ m.T, sig)
        edge_checks(params, small, small_basic, sig, lib)
        second_card(params)

        phase = "(f)"
        banked_path = bm_path + ["fused_group_step_banked"]
        two_path = bm_path + ["extract_groups", "accumulate_groups_fused"]
        p17 = {}
        for fused, path in ((None, banked_path), (False, two_path)):
            route = build_kernel_step(params.ht, params.lambda_3d, 17, 17,
                                      128, 128, 3, False, "float32",
                                      str(dev), fused).route
            (b17, f17), counts = drive(
                f"(f) route {route}", kernels, path,
                lambda: run_bm5d(mid, params, engine="auto", fused=fused))
            for name in path[2:]:
                launches[name] = counts[name]
            p17[route] = psnr_device(f17, mid_clean)
            print(f"(f) 17x17x128x128 RGB matched, route {route}: PSNR "
                  f"noisy {psnr_device(mid, mid_clean):.3f} / basic "
                  f"{psnr_device(b17, mid_clean):.3f} / final "
                  f"{p17[route]:.3f} dB")
            if p17[route] < PSNR_17_MIN:
                raise AssertionError(f"17x17 PSNR below the record on route "
                                     f"{route}")
        if abs(p17["banked"] - p17["two_kernel"]) > PSNR_DELTA_MAX:
            raise AssertionError(f"the routes disagree: {p17}")
        del mid, mid_clean, xm, x17

        phase = "(g)"
        torch.cuda.reset_peak_memory_stats()
        ((bb, fb), dt), _ = drive("(g)", kernels, banked_path,
                                  lambda: timed_run(big, params))
        peak = torch.cuda.max_memory_allocated()
        mpix = 17 * 17 * 512 * 512 / 1e6
        print(f"(g) 17x17x512x512 RGB matched (route banked): {dt:.4f} s/LF "
              f"= {mpix / dt:.3f} Mpix/s; PSNR noisy "
              f"{psnr_device(big, big_clean):.3f} / basic "
              f"{psnr_device(bb, big_clean):.3f} / final "
              f"{psnr_device(fb, big_clean):.3f} dB; peak device memory "
              f"{peak / 2**30:.2f} GiB")
        if not bool(torch.isfinite(fb).all()) or fb.shape != big.shape:
            raise AssertionError("17x17x512x512 output is not finite")
        del big, big_clean, bb, fb

        phase = "(h)"
        lf_h = add_noise_np(synthetic_lf(9, 9, 24, 32, channels=3, seed=0),
                            25.0, seed=1)
        clean_h = synthetic_lf(9, 9, 24, 32, channels=3, seed=0)
        h_ref = {}  # preset -> final PSNR of the f64 plain pipeline, for (p)
        for preset in ("default", "robust"):
            ph = preset_denoise_params(preset, 25.0)
            (_, f_gpu), _ = drive(
                f"(h) {preset}", kernels, banked_path,
                lambda: run_bm5d(lf_h, ph, engine="auto", device=dev))
            t0 = time.perf_counter()
            _, f_ref = run_bm5d(lf_h, ph, dtype="float64", engine="torch",
                                device=dev)
            h_ref[preset] = psnr_device(f_ref, clean_h)
            d_ps = psnr_device(f_gpu, clean_h) - h_ref[preset]
            print(f"(h) {preset} 9x9x24x32 RGB: kernels (route banked, f32) "
                  f"{psnr_device(f_gpu, clean_h):.3f} dB vs plain f64 "
                  f"{psnr_device(f_ref, clean_h):.3f} dB (delta {d_ps:+.4f}; "
                  f"plain "
                  f"f64 {time.perf_counter() - t0:.1f} s)")
            if abs(d_ps) > PSNR_DELTA_MAX:
                raise AssertionError(f"{preset} preset disagrees with the "
                                     f"f64 reference")

        phase = "(i)"
        noisy_dev, clean_dev = lf_on_card(9, 434, 625, 1)
        mpix = 9 * 9 * 434 * 625 / 1e6
        for preset, (p_min, s_max) in PRESET_MIN.items():
            ph = preset_denoise_params(preset, 25.0)
            torch.cuda.reset_peak_memory_stats()
            ((b_i, f_i), dt), _ = drive(f"(i) {preset}", kernels, banked_path,
                                        lambda: timed_run(noisy_dev, ph))
            p_final = psnr_device(f_i, clean_dev)
            print(f"(i) flagship 9x9x434x625 RGB {preset} (route banked): "
                  f"{dt:.4f} s/LF = {mpix / dt:.3f} Mpix/s; PSNR basic "
                  f"{psnr_device(b_i, clean_dev):.3f} / final "
                  f"{p_final:.3f} dB; "
                  f"peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if not bool(torch.isfinite(f_i).all()) or p_final < p_min:
                raise AssertionError(f"{preset} at the flagship: final PSNR "
                                     f"{p_final:.3f} below {p_min}")
            if dt > s_max:
                raise AssertionError(f"{preset} at the flagship: {dt:.1f} "
                                     f"s/LF over the {s_max} s ceiling")
            del b_i, f_i

        phase = "(j)"
        rows["gather_rows"] = phase_gather(
            params, noisy_dev @ m.T, lf_on_card(17, 128, 128, 100)[0] @ m.T,
            sig)

        phase = "(k)"
        launches["gather_rows"] = phase_doff(kernels, fused_path, params,
                                             noisy_dev, clean_dev, d_final,
                                             d_dt)

        phase = "(l)"
        phase_sr(kernels, fused_path)

        phase = "(m)"
        phase_router(kernels, banked_path, noisy_dev)
        del noisy_dev, clean_dev

        phase = "(n)"
        clean_np, noisy_np = flagship_batch()
        phase_batch(kernels, fused_path, params, clean_np, noisy_np)

        phase = "(o)"
        phase_disk(kernels, fused_path, params, clean_np, noisy_np)
        del clean_np, noisy_np

        phase = "(p)"
        bf16_rows, bf16_launches = phase_bf16(kernels, lib, params, sig, m,
                                              d_final, h_ref)
        rows.update(bf16_rows)
        launches.update(bf16_launches)

        phase = "(q)"
        phase_nonsquare(kernels, lib, sig, m)

        phase = "(r)"
        phase_bench(kernels, bm_path, d_final, d_dt)
        bad = [n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "lfbm5d_tpu")]
        if bad:
            raise AssertionError(f"the JAX package or jax was imported: {bad}")
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
        "fused_group_step_banked": ("lfbm5d_torch/csrc/fused_banked.cu",
                                    "lfbm5d_tpu/kernels/fused.py:796"),
        "fused_group_step_bf16": ("lfbm5d_torch/csrc/fused.cu",
                                  "lfbm5d_tpu/kernels/fused.py:433"),
        "fused_group_step_banked_bf16": ("lfbm5d_torch/csrc/fused_banked.cu",
                                         "lfbm5d_tpu/kernels/fused.py:796"),
        "extract_groups": ("lfbm5d_torch/csrc/twokernel.cu",
                           "lfbm5d_tpu/kernels/extract.py:64"),
        "accumulate_groups_fused": ("lfbm5d_torch/csrc/twokernel.cu",
                                    "lfbm5d_tpu/kernels/accumulate.py:106"),
        "accumulate_groups": ("lfbm5d_torch/csrc/twokernel.cu",
                              "lfbm5d_tpu/kernels/accumulate.py:185"),
        "gather_rows": ("lfbm5d_torch/csrc/gather.cu",
                        "lfbm5d_tpu/kernels/gather.py:196"),
    }
    out = []
    for name, (src, rep) in replaces.items():
        row = {"library_ms": None, **rows[name]}
        out.append(dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=launches.get(name, 0), **row))
    print(card_line())
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
