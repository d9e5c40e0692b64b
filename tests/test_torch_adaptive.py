"""The port's LF-level content router against `lfbm5d_tpu.pipeline.adaptive`
on the families of tests/test_adaptive.py, its tensor probe (corner SAIs
quantised on the tensor's device) and `lf.io.fetch_rounded`."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.lf.io import fetch_rounded as j_fetch_rounded
from lfbm5d_tpu.pipeline import adaptive as jad
from lfbm5d_torch import config as tcfg
from lfbm5d_torch.lf import add_noise_np, synthetic_lf, synthetic_lf_multi
from lfbm5d_torch.lf.io import fetch_rounded
from lfbm5d_torch.pipeline import adaptive as tad

torch.set_num_threads(2)


def _noisy(seed, bg, fg, sigma=25.0, a=9, h=224, w=320):
    clean = synthetic_lf(a, a, h, w, channels=3, disp_bg=bg, disp_fg=fg,
                         seed=seed)
    return add_noise_np(clean, sigma, seed=seed + 1)


def _noisy_grad(seed, sigma=25.0, a=9, h=224, w=320):
    clean = synthetic_lf_multi(a, a, h, w, channels=3,
                               disps=(0.5, 1.5, 3.0), seed=seed,
                               blob_frac=0.3, texture_grad=0.7)
    return add_noise_np(clean, sigma, seed=seed + 1)


FAMILIES = {
    "two-plane-0": (lambda: _noisy(0, 1, 2), "matched"),
    "two-plane-7": (lambda: _noisy(7, 2, 3), "matched"),
    "static-bg-11": (lambda: _noisy(11, 0, 1), "matched"),
    "static-min-4": (lambda: _noisy(4, 1, 0), "matched"),
    "occl-grad-0": (lambda: _noisy_grad(0), "robust"),
    "occl-grad-5": (lambda: _noisy_grad(5), "robust"),
    "flat": (lambda: add_noise_np(np.full((3, 3, 32, 32, 1), 128.0), 25.0,
                                  seed=0), "matched"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_probe_and_route_equal_reference(family):
    make, route = FAMILIES[family]
    lf = make()
    stats, maps = tad.probe_maps(lf, 25.0)
    jstats, jmaps = jad.probe_maps(lf, 25.0)
    assert stats == jstats
    for key in ("weak", "static"):
        np.testing.assert_array_equal(maps[key], jmaps[key])
    assert tad.content_stats(lf, 25.0) == jad.content_stats(lf, 25.0)
    assert tad.select_preset(lf, 25.0) == jad.select_preset(lf, 25.0)
    assert tad.select_preset(lf, 25.0)[0] == route
    params, name, st = tad.adaptive_denoise_params(lf, 25.0, chunk=128)
    assert (name, st) == (route, stats)
    assert params == tcfg.preset_denoise_params(route, 25.0, chunk=128)


@pytest.mark.parametrize("family", ["two-plane-0", "occl-grad-0"])
def test_tensor_probe_equals_host_probe(family):
    """A tensor fetches only the corner SAIs, quantised: on an LF already on
    the quantisation grid it probes exactly as its array; on raw noisy
    values the stats stay within the reference's own device/host band."""
    noisy = FAMILIES[family][0]()
    grid = np.floor(np.clip(noisy, 0.0, 255.0) + 0.5)
    src = tad._probe_source(torch.as_tensor(grid, dtype=torch.float32))
    assert src.shape == (2, 1, *grid.shape[2:]) and src.dtype == np.float64
    np.testing.assert_array_equal(src[0, 0], grid[0, 0])
    np.testing.assert_array_equal(src[1, 0], grid[-1, -1])
    t = torch.as_tensor(grid, dtype=torch.float32)
    assert tad.content_stats(t, 25.0) == tad.content_stats(grid, 25.0)
    assert tad.select_preset(t, 25.0) == tad.select_preset(grid, 25.0)
    raw = tad.content_stats(torch.as_tensor(noisy), 25.0)
    host = tad.content_stats(noisy, 25.0)
    assert abs(raw["weak_fraction"] - host["weak_fraction"]) < 0.02
    assert abs(raw["static_fraction"] - host["static_fraction"]) < 0.02


def test_one_by_one_tensor_takes_the_host_guard():
    lf = add_noise_np(np.full((1, 1, 40, 48, 3), 90.0), 25.0, seed=3)
    want = tad.content_stats(lf, 25.0)
    assert want == jad.content_stats(lf, 25.0) and want["n_blocks"] == 0
    assert tad.content_stats(torch.as_tensor(lf), 25.0) == want
    _, maps = tad.probe_maps(tad._probe_source(torch.as_tensor(lf)), 25.0)
    assert maps["weak"].shape == (5, 6) and not maps["weak"].any()


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_fetch_rounded_equals_reference(bit_depth):
    x = np.concatenate([
        np.random.default_rng(bit_depth).uniform(-20.0, 280.0, 500),
        [0.5, 1.5, 254.5, 255.49, -0.4, 255.6, 2.5 / 257, 3.5 / 257],
    ]).astype(np.float32).reshape(2, 254)
    got = fetch_rounded(torch.as_tensor(x), bit_depth)
    want = j_fetch_rounded(jnp.asarray(x), bit_depth)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fetch_rounded(x, bit_depth), x)


def test_constants_equal_reference():
    for name in ("WEAK_FRACTION_THRESHOLD", "_WEAK_FACTOR",
                 "_INFORMATIVE_FACTOR", "_STATIC_NOISE_FACTOR",
                 "_STATIC_CONTENT_FRACTION"):
        assert getattr(tad, name) == getattr(jad, name), name
    p = tad.adaptive_denoise_params(FAMILIES["flat"][0](), 25.0)[0]
    assert dataclasses.asdict(p) == dataclasses.asdict(
        tcfg.preset_denoise_params("matched", 25.0))
