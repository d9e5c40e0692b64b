"""The port's command line (`python -m lfbm5d_torch.cli`) against the
reference's (`lfbm5d_tpu.cli`), on the CPU: the same LF directory and the
same flags through both, the written SAIs within 1 LSB of each other and
the --json reports with the same keys; the positional forms; the engine
names; and the card as the default device."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lfbm5d_tpu import config as jconfig
from lfbm5d_tpu.cli import main as j_main
from lfbm5d_torch import cli as tcli
from lfbm5d_torch.lf import synthetic_lf
from lfbm5d_torch.lf.io import load_lf, save_lf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAT = "SAI_%02d_%02d.png"
TINY = [
    "--ht-nsim", "8", "--ht-nsearch", "4", "--ht-ndisp", "1", "--ht-p", "3",
    "--wien-nsim", "8", "--wien-nsearch", "4", "--wien-ndisp", "1",
    "--wien-p", "3", "--chunk", "32",
]


def t_main(argv):
    return tcli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def lf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lf")
    clean = synthetic_lf(2, 2, 20, 24, channels=3, seed=0)
    save_lf(clean, str(d), PAT)
    return str(d), clean


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _within_lsb(a_dir, b_dir, a_h=2, a_w=2):
    a, b = load_lf(a_dir, PAT, a_h, a_w), load_lf(b_dir, PAT, a_h, a_w)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1.0


def test_denoise_matches_reference(lf_dir, tmp_path, capsys):
    d, clean = lf_dir
    runs = {}
    for tag, main in (("ref", j_main), ("port", t_main)):
        out = tmp_path / tag
        rc = main(["denoise", "--input", d, "--aheight", "2", "--awidth",
                   "2", "--sigma-add", "20", "--output", str(out / "out"),
                   "--basic", str(out / "basic"), "--diff",
                   str(out / "diff"), "--per-sai-psnr", "--json", *TINY])
        assert rc == 0
        runs[tag] = _report(capsys)
    ref, port = runs["ref"], runs["port"]
    assert list(port) == list(ref)
    assert port["psnr_final_db"] > port["psnr_noisy_db"] + 2.0
    for key in ("psnr_noisy_db", "psnr_basic_db", "psnr_final_db"):
        assert abs(port[key] - ref[key]) <= 0.05, key
    grid = np.asarray(port["psnr_per_sai_db"])
    assert grid.shape == (2, 2)
    np.testing.assert_allclose(grid, ref["psnr_per_sai_db"], atol=0.1)
    for sub in ("out", "basic", "diff"):
        _within_lsb(str(tmp_path / "ref" / sub), str(tmp_path / "port" / sub))


def test_denoise_requires_sigma(lf_dir, tmp_path):
    d, _ = lf_dir
    argv = ["denoise", "--input", d, "--aheight", "2", "--awidth", "2",
            "--output", str(tmp_path / "o"), *TINY]
    assert t_main(argv) == j_main(argv) == 2
    bad = ["denoise", "--input", str(tmp_path / "none"), "--aheight", "2",
           "--awidth", "2", "--sigma", "20", "--output", str(tmp_path / "o")]
    assert t_main(bad) == 2


def test_sr_matches_reference(lf_dir, tmp_path, capsys):
    d, _ = lf_dir
    runs = {}
    for tag, main in (("ref", j_main), ("port", t_main)):
        rc = main(["sr", "--input", d, "--aheight", "2", "--awidth", "2",
                   "--scale", "2", "--n-iter", "2", "--output",
                   str(tmp_path / tag / "hr"), "--checkpoint",
                   str(tmp_path / tag / "ck"), "--json", *TINY])
        assert rc == 0
        runs[tag] = _report(capsys)
    assert list(runs["port"]) == list(runs["ref"])
    assert runs["port"]["shape_out"] == [2, 2, 40, 48, 3]
    for sub in ("hr", "ck/iter_00", "ck/iter_01"):
        _within_lsb(str(tmp_path / "ref" / sub), str(tmp_path / "port" / sub))
    assert t_main(["sr", "--input", d, "--aheight", "2", "--awidth", "2",
                   "--output", str(tmp_path / "x"), "--preset",
                   "adaptive"]) == 2


def test_positional_forms_match_reference(tmp_path):
    clean = synthetic_lf(2, 2, 16, 16, channels=3, seed=3)
    inp = str(tmp_path / "clean")
    save_lf(clean, inp, PAT)
    for tag, main in (("ref", j_main), ("port", t_main)):
        out, basic = str(tmp_path / tag / "out"), str(tmp_path / tag / "b")
        argv = (f"denoise {inp} {PAT} 2 2 0 0 20 1 2.7 "
                "4 3 1 8 4 dct 0 dct haar 4 3 1 8 4 dct 0 dct haar "
                f"opp {out} {basic} none").split()
        assert main(argv) == 0
        hr, ck = str(tmp_path / tag / "hr"), str(tmp_path / tag / "ck")
        argv = (f"sr {inp} {PAT} 2 2 0 0 2 2 12 4 1.0 2.7 "
                "4 3 1 8 4 dct 0 dct haar 4 3 1 8 4 dct 0 dct haar "
                f"opp {hr} {ck} 4").split()
        assert main(argv) == 0
    for sub in ("out", "b"):
        _within_lsb(str(tmp_path / "ref" / sub), str(tmp_path / "port" / sub))
    _within_lsb(str(tmp_path / "ref" / "hr"), str(tmp_path / "port" / "hr"))
    with pytest.raises(SystemExit):
        t_main(["sr", inp, PAT, "2", "2"])
    with pytest.raises(SystemExit):
        t_main(["denoise", inp, PAT, "2", "2"])


def test_engine_names_and_presets(lf_dir, tmp_path, capsys):
    """pallas runs the kernels ('auto'), pallas_bf16 the kernels with the
    bfloat16 chain ('auto_bf16'), xla the plain engine ('torch'): the same
    PNGs, byte for byte, as the port's own names; --preset adaptive reports
    the routed preset under the reference's keys."""
    d, _ = lf_dir
    base = ["denoise", "--input", d, "--aheight", "2", "--awidth", "2",
            "--sigma", "20", "--json", *TINY]
    # the plain versions' scatter-adds (index_put_ with accumulate) sum in
    # no fixed order on several host threads; fix it, so two runs of one
    # engine write the same bytes
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for ref_name, port_name in (("pallas", "auto"),
                                    ("pallas_bf16", "auto_bf16"),
                                    ("xla", "torch")):
            for name in (ref_name, port_name):
                assert t_main([*base, "--engine", name, "--output",
                               str(tmp_path / name)]) == 0
            for sai in sorted(os.listdir(tmp_path / ref_name)):
                with open(tmp_path / ref_name / sai, "rb") as f:
                    ref_bytes = f.read()
                with open(tmp_path / port_name / sai, "rb") as f:
                    assert f.read() == ref_bytes, (ref_name, sai)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    capsys.readouterr()
    runs = {}
    for tag, main in (("ref", j_main), ("port", t_main)):
        assert main([*base, "--preset", "adaptive", "--output",
                     str(tmp_path / f"ad_{tag}")]) == 0
        runs[tag] = _report(capsys)
    assert list(runs["port"]) == list(runs["ref"])
    assert runs["port"]["preset_selected"] == runs["ref"]["preset_selected"]
    assert runs["port"]["static_fraction"] == runs["ref"]["static_fraction"]


def test_presets_track_config_presets():
    for name, over in jconfig.PRESETS.items():
        assert tcli._PRESETS[name] == {
            tcli._FIELD_TO_FLAG[f]: v for f, v in over.items()}


def test_runs_on_the_card_by_default(lf_dir, tmp_path, monkeypatch):
    """Without --device the CLI runs on the CUDA card, and raises where
    there is none."""
    d, _ = lf_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    io = ["--input", d, "--aheight", "2", "--awidth", "2", "--output",
          str(tmp_path / "o")]
    for argv in (["denoise", *io, "--sigma", "20"], ["sr", *io]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def test_module_entry_point(lf_dir, tmp_path):
    """`python -m lfbm5d_torch.cli` in a fresh process: runs, prints the
    JSON report last, and loads neither jax nor the JAX package."""
    d, _ = lf_dir
    code = (
        "import runpy, sys\n"
        "sys.argv = ['lfbm5d'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('lfbm5d_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('jax') or m.startswith('lfbm5d_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code, "denoise", "--input", d, "--aheight",
         "2", "--awidth", "2", "--sigma", "20", "--json", "--device", "cpu",
         "--output", str(tmp_path / "m"), *TINY],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    assert rep["mode"] == "denoise" and rep["shape"] == [2, 2, 20, 24, 3]
