"""The port's bench (`python -m lfbm5d_torch.bench`) against the reference's
`bench.py`, on the CPU at small shapes: every flag and choice of
`bench.py --help`, the same input LFs, the row against the JAX package's
`run_bm5d(engine="xla")` with every key of the reference's JSON line, the
adaptive rows' pick against the reference's router, the profiler's trace,
the one JSON line of `main`, and the refusal to run without a card."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lfbm5d_tpu.config import preset_denoise_params as j_preset
from lfbm5d_tpu.lf import psnr as j_psnr
from lfbm5d_tpu.lf import synthetic_lf as j_synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np as j_add_noise_np
from lfbm5d_tpu.lf.synth import synthetic_lf_multi as j_synthetic_lf_multi
from lfbm5d_tpu.pipeline import run_bm5d as j_run_bm5d
from lfbm5d_tpu.pipeline.adaptive import select_preset as j_select_preset
from lfbm5d_torch import bench
from lfbm5d_torch.cli import _ENGINES

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's family kwargs (bench.py:122-136), the two-plane LF beside them
J_FAMILIES = {
    "two-plane": lambda a, b, h, w: j_synthetic_lf(
        a, b, h, w, channels=3, disp_bg=1, disp_fg=2, seed=0),
    "low-disp": lambda a, b, h, w: j_synthetic_lf(
        a, b, h, w, 3, disp_bg=0, disp_fg=1, seed=0),
    "occl3": lambda a, b, h, w: j_synthetic_lf_multi(
        a, b, h, w, 3, disps=(0.5, 1.5, 3.0), seed=0, blob_frac=0.3),
    "occl-grad": lambda a, b, h, w: j_synthetic_lf_multi(
        a, b, h, w, 3, disps=(0.5, 1.5, 3.0), seed=0, blob_frac=0.3,
        texture_grad=0.7),
    "static-min": lambda a, b, h, w: j_synthetic_lf(
        a, b, h, w, 3, disp_bg=0, disp_fg=2, seed=0),
    "static-flat": lambda a, b, h, w: j_synthetic_lf_multi(
        a, b, h, w, 3, disps=(0.0, 2.0), seed=0, blob_frac=0.25,
        flat_frac=0.4),
}
# a value for each option of bench.py that takes one, by its metavar
METAVAR_VALUES = {"RUNS": "2", "SIGMA": "15", "DIR": "trace_dir"}


def reference_result_keys():
    """The keys of bench.py's `result` dict literal, read with ast."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no `result` dict literal")


@pytest.fixture(scope="module")
def reference_options():
    """[(option, None | [values])] of `python bench.py --help`."""
    res = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    opts = []
    for line in res.stdout.split("options:", 1)[1].splitlines():
        m = re.match(r"^  (--[a-z-]+)(?: (\{[^}]*\}|[A-Z_]+))?", line)
        if not m or m.group(1) == "--help":
            continue
        arg = m.group(2)
        if arg is None:
            opts.append((m.group(1), None))
        elif arg.startswith("{"):
            opts.append((m.group(1), arg[1:-1].split(",")))
        else:
            opts.append((m.group(1), [METAVAR_VALUES[arg]]))
    return opts


def test_parse_takes_every_reference_flag(reference_options):
    """(a) Every option and choice of bench.py is accepted by parse, the
    engine names mapped as the CLI maps them."""
    names = {o for o, _ in reference_options}
    assert names == {"--full", "--proxy", "--quick", "--runs", "--preset",
                     "--engine", "--sigma", "--family", "--profile"}
    for opt, values in reference_options:
        attr = opt[2:].replace("-", "_")
        if values is None:
            assert getattr(bench.parse([opt]), attr) is True
            continue
        for v in values:
            got = getattr(bench.parse([opt, v]), attr)
            if opt == "--engine":
                assert got == _ENGINES[v]
            else:
                assert str(got) == v or got == float(v)
    assert {v: bench.parse(["--engine", v]).engine
            for v in ("auto", "pallas", "xla", "pallas_bf16")} == {
        "auto": "auto", "pallas": "auto", "xla": "torch",
        "pallas_bf16": "auto_bf16"}


@pytest.mark.parametrize("argv, shape, preset", [
    ([], (9, 9, 434, 625), "matched"),
    (["--full"], (9, 9, 434, 625), "matched"),
    (["--proxy"], (5, 5, 192, 256), "fast"),
    (["--quick"], (3, 3, 96, 128), "fast"),
    (["--quick", "--preset", "robust"], (3, 3, 96, 128), "robust"),
])
def test_parse_shapes_and_default_presets(argv, shape, preset):
    """(a) bench.py's shapes and default presets; --runs 3, sigma 25, the
    two-plane LF, the auto engine and the card by default."""
    args = bench.parse(argv)
    assert (args.shape, args.preset) == (shape, preset)
    assert (args.runs, args.sigma, args.family, args.engine, args.device,
            args.profile) == (3, 25.0, "two-plane", "auto", None, None)


@pytest.mark.parametrize("family", sorted(J_FAMILIES))
def test_bench_inputs_match_reference(family):
    """(b) The same clean and noisy LFs as bench.py, array for array."""
    clean, noisy = bench.bench_inputs(3, 3, 24, 32, family, 25.0)
    want = J_FAMILIES[family](3, 3, 24, 32)
    assert clean.dtype == want.dtype and np.array_equal(clean, want)
    assert np.array_equal(noisy, j_add_noise_np(want, 25.0, seed=1))


def test_measure_matches_jax_engine(monkeypatch):
    """(c) A `fast` row at 3x3x32x40 on the kernel engine's plain versions:
    the final LF within 2e-3 of the JAX package's kernel engine (`pallas`,
    interpret mode), its PSNR within 0.05 dB of the JAX package's xla
    engine, every key of bench.py's line, value = mpix / seconds_per_lf,
    vs_baseline null. (At this shape the reference's own xla and pallas
    engines differ by more than 2e-3 in f32 where a quantised
    block-matching distance flips, as docs/PARITY.md records; in float64
    both agree with the port to 1e-9, tests/test_torch_pipeline.py.)"""
    clean, noisy = bench.bench_inputs(3, 3, 32, 40, "two-plane", 25.0)
    finals = []

    def recording(*a, **kw):
        out = run(*a, **kw)
        finals.append(out[1])
        return out

    run = bench.run_bm5d
    monkeypatch.setattr(bench, "run_bm5d", recording)
    res = bench.measure(noisy, clean, device="cpu", engine="auto",
                        preset="fast", sigma=25.0, runs=1)
    assert len(finals) == 2  # the untimed first run and one timed run
    params = j_preset("fast", 25.0, chunk=128)
    _, j_kernel = j_run_bm5d(noisy, params, engine="pallas")
    err = np.abs(finals[-1].numpy() - np.asarray(j_kernel)).max()
    assert err <= 2e-3, err
    _, j_xla = j_run_bm5d(noisy, params, engine="xla")
    j_db = j_psnr(np.clip(np.asarray(j_xla), 0, 255), clean)
    assert abs(res["psnr_final_db"] - j_db) <= 0.05
    assert res["psnr_noisy_db"] == pytest.approx(
        j_psnr(np.clip(noisy, 0, 255), clean), abs=1e-9)
    assert reference_result_keys() <= set(res)
    assert res["vs_baseline"] is None
    assert res["value"] == pytest.approx(
        res["mpix"] / res["seconds_per_lf"], rel=1e-12)
    assert res["seconds_per_lf"] == min(res["run_seconds"])
    assert (res["shape"], res["preset"], res["family"], res["quick"],
            res["engine"], res["device"]["name"]) == (
        [3, 3, 32, 40, 3], "fast", "two-plane", False, "auto", "cpu")
    assert res["psnr_final_db"] > res["psnr_noisy_db"] + 2.0
    json.dumps(res)


@pytest.mark.parametrize("preset", ["adaptive", "adaptive-region"])
def test_adaptive_rows_pick_as_reference(preset):
    """(d) The adaptive rows' pick equals the reference's select_preset on
    the same noisy LF: matched on two-plane, robust on occl-grad (at this
    size the region composite's box covers the frame, so the
    adaptive-region row takes the LF-level pick too)."""
    picks = {}
    for family in ("two-plane", "occl-grad"):
        clean, noisy = bench.bench_inputs(2, 2, 32, 40, family, 25.0)
        res = bench.measure(noisy, clean, device="cpu", engine="xla",
                            preset=preset, sigma=25.0, runs=1,
                            family=family)
        picks[family] = res["adaptive_selected"]
        assert picks[family] == j_select_preset(noisy, 25.0)[0]
        assert res["engine"] == "torch" and res["preset"] == preset
        assert f"family={family}" in res["metric"] or family == "two-plane"
        assert np.isfinite(res["psnr_final_db"])
    assert picks == {"two-plane": "matched", "occl-grad": "robust"}


def test_main_prints_one_json_line(monkeypatch, capsys, tmp_path):
    """main: the --quick row (its shape cut to 2x2x16x24 here) with a
    reference engine name and --profile prints one JSON line as the last
    line, writes a Chrome trace of the timed runs to DIR and the top ops
    (by the host's self time on the CPU) to stderr."""
    monkeypatch.setitem(bench.SHAPES, "quick", (2, 2, 16, 24))
    prof = tmp_path / "prof"
    assert bench.main(["--quick", "--device", "cpu", "--runs", "2",
                       "--engine", "pallas", "--profile", str(prof)]) == 0
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert (res["shape"], res["preset"], res["quick"], res["engine"]) == (
        [2, 2, 16, 24, 3], "fast", True, "auto")
    assert len(res["run_seconds"]) == 2 and "quick smoke config" in (
        res["metric"])
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "host self-time total" in err
    tops = [ln for ln in err.splitlines()
            if re.match(r"^ *\d+\.\d+s +\d+x ", ln)]
    assert 0 < len(tops) <= bench.PROFILE_TOP


def test_no_card_fails_without_json():
    """(e) Without a card and without --device cpu the bench fails with
    resolve_device's message and prints no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench runs on it")
    res = subprocess.run([sys.executable, "-m", "lfbm5d_torch.bench",
                          "--quick"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "{" not in res.stdout
