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
                 "_STATIC_CONTENT_FRACTION", "REGION_MARGIN",
                 "REGION_ROUND_TO", "REGION_FULL_ROBUST_FRAC",
                 "REGION_MIN_WEAK_BLOCKS"):
        assert getattr(tad, name) == getattr(jad, name), name
    p = tad.adaptive_denoise_params(FAMILIES["flat"][0](), 25.0)[0]
    assert dataclasses.asdict(p) == dataclasses.asdict(
        tcfg.preset_denoise_params("matched", 25.0))


# --- the region composite (denoise_region_adaptive) -----------------------


def _flat_bg_weak_patch(box, a=3, h=96, w=160, sigma=25.0):
    """Featureless background and one pasted low-contrast texture, the
    same in every SAI (tests/test_adaptive.py's weak-patch case): the weak
    map flags exactly the patch's blocks."""
    y0, y1, x0, x1 = box
    clean = np.full((a, a, h, w, 1), 128.0)
    cells = 128.0 + np.random.default_rng(100).uniform(
        -16.0, 16.0, ((y1 - y0) // 8 + 1, (x1 - x0) // 8 + 1))
    clean[:, :, y0:y1, x0:x1, 0] = np.kron(
        cells, np.ones((8, 8)))[: y1 - y0, : x1 - x0]
    return add_noise_np(clean, sigma, seed=1)


def _region_params(n_search):
    step = dict(n_sim=4, n_search=n_search, n_disp=1, p=6, tau_2d="dct")
    return tcfg.DenoiseParams(
        sigma=25.0, ht=tcfg.StepParams(tau_match=2500.0, **step),
        wiener=tcfg.StepParams(tau_match=400.0, **step), chunk=64)


def _j(params):
    from lfbm5d_tpu.config import DenoiseParams, StepParams

    return DenoiseParams(
        sigma=params.sigma, chunk=params.chunk,
        ht=StepParams(**dataclasses.asdict(params.ht)),
        wiener=StepParams(**dataclasses.asdict(params.wiener)))


@pytest.mark.parametrize("flags", [
    np.s_[5:9, 8:14], np.s_[0:2, 0:3], np.s_[14:16, 20:24], np.s_[:, :],
    np.s_[3:4, 23:24]])
@pytest.mark.parametrize("margin,round_to", [(48, 32), (16, 16), (5, 7)])
def test_static_region_box_and_feather_equal_reference(flags, margin,
                                                        round_to):
    h, w = 128, 192
    fmap = np.zeros((h // 8, w // 8), bool)
    fmap[flags] = True
    box = tad.static_region_box(fmap, h, w, 8, margin, round_to)
    assert box == jad.static_region_box(fmap, h, w, 8, margin, round_to)
    y0, y1, x0, x1 = box
    f = tad._feather(y1 - y0, x1 - x0, box, h, w, margin)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(
        f, jad._feather(y1 - y0, x1 - x0, box, h, w, margin))
    assert tad.static_region_box(np.zeros_like(fmap), h, w) is None


def test_region_composite_equals_reference():
    """The probe-driven region route (no mocking): the same box, route and
    crop as the reference, the output equal to the reference's (XLA engine)
    in float64 within docs/PARITY.md's 1e-9; outside the
    box it is the matched pass, inside the feather-complete interior the
    robust crop pass."""
    noisy = _flat_bg_weak_patch((32, 56, 64, 96))
    p_m, p_r = _region_params(4), _region_params(6)
    kw = dict(margin=16, round_to=16, min_weak_blocks=4)
    jb, jf, jinfo = jad.denoise_region_adaptive(
        noisy, 25.0, engine="xla", dtype="float64", params_matched=_j(p_m),
        params_robust=_j(p_r), **kw)
    b, f, info = tad.denoise_region_adaptive(
        noisy, 25.0, dtype="float64", device="cpu", params_matched=p_m,
        params_robust=p_r, **kw)
    assert info == jinfo and info["mode"] == "region"
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-9)
    y0, y1, x0, x1 = info["box"]
    from lfbm5d_torch.pipeline.denoise import run_bm5d

    fm = run_bm5d(noisy, p_m, dtype="float64", device="cpu")[1]
    outside = torch.ones(f.shape, dtype=torch.bool)
    outside[:, :, y0:y1, x0:x1] = False
    assert torch.equal(f[outside], fm[outside])
    fr = run_bm5d(noisy[:, :, y0:y1, x0:x1], p_r, dtype="float64",
                  device="cpu")[1]
    iy0, iy1 = y0 + 16 * (y0 > 0), y1 - 16 * (y1 < 96)
    ix0, ix1 = x0 + 16 * (x0 > 0), x1 - 16 * (x1 < 160)
    torch.testing.assert_close(
        f[:, :, iy0:iy1, ix0:ix1],
        fr[:, :, iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("weak_fraction,route", [(0.58, "matched"),
                                                 (0.75, "robust")])
def test_large_box_falls_back_to_lf_level_route(monkeypatch, weak_fraction,
                                                route):
    """A frame-spanning weak-block box saves nothing: strong content (weak
    fraction under the threshold) runs matched, weak content robust, as the
    LF-level router decides, with the box and its area in info; the probe
    is stubbed to that landscape in both packages, as the reference's
    tests do."""
    noisy = add_noise_np(
        synthetic_lf(3, 3, 64, 96, channels=1, disp_bg=1, disp_fg=2, seed=0),
        25.0, seed=1)
    wmap = np.zeros((8, 12), bool)
    wmap[:2, :3] = True
    wmap[-2:, -3:] = True
    stats = {"weak_fraction": weak_fraction, "static_fraction": 0.55,
             "n_informative": 40, "n_blocks": 96, "noise_var_block": 19.5}

    def stub(lf, sigma, block=8):
        return dict(stats), {"weak": wmap, "static": np.zeros_like(wmap)}

    monkeypatch.setattr(tad, "probe_maps", stub)
    monkeypatch.setattr(jad, "probe_maps", stub)
    p_m, p_r = _region_params(4), _region_params(6)
    b, f, info = tad.denoise_region_adaptive(
        noisy, 25.0, dtype="float64", device="cpu", params_matched=p_m,
        params_robust=p_r)
    _, jf, jinfo = jad.denoise_region_adaptive(
        noisy, 25.0, engine="xla", dtype="float64", params_matched=_j(p_m),
        params_robust=_j(p_r))
    assert info == jinfo and info["mode"] == route
    assert info["area_frac"] >= 0.7
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-9)


def test_region_without_weak_blocks_routes_lf_level():
    """No weak block: the LF-level route, without a box, as the reference
    (and a tensor input keeps its device)."""
    noisy = add_noise_np(np.full((2, 2, 32, 40, 1), 128.0), 25.0, seed=2)
    p_m, p_r = _region_params(3), _region_params(4)
    b, f, info = tad.denoise_region_adaptive(
        torch.as_tensor(noisy), 25.0, dtype="float64", params_matched=p_m,
        params_robust=p_r)
    assert info["mode"] == "matched" and "box" not in info
    assert f.device.type == "cpu"
    from lfbm5d_torch.pipeline.denoise import run_bm5d

    assert torch.equal(f, run_bm5d(noisy, p_m, dtype="float64",
                                   device="cpu")[1])


def test_region_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tad.denoise_region_adaptive(np.zeros((2, 2, 16, 16, 1)), 25.0)
