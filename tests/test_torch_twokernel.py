"""The two-kernel path and the routes of the kernel step against the JAX
reference (CPU, float64): extract/accumulate plain versions against the
Pallas kernels in interpret mode, the flat transforms against
`lfbm5d_tpu.transforms.flat`, every route's step num/den against the
reference's `_build_step`, and a 17x17 pipeline against the XLA engine."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import StepParams, preset_denoise_params
from lfbm5d_tpu.kernels.accumulate import (
    accumulate_groups as j_accumulate,
    accumulate_groups_fused as j_accumulate_fused,
)
from lfbm5d_tpu.kernels.extract import extract_groups as j_extract
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.pipeline import denoise as jden
from lfbm5d_tpu.pipeline import run_bm5d as j_run_bm5d
from lfbm5d_tpu.transforms import flat as jflat
from lfbm5d_tpu.transforms import matrices as jm
from lfbm5d_torch import config as tcfg
from lfbm5d_torch import run_bm5d
from lfbm5d_torch.config import from_reference
from lfbm5d_torch.kernels.accumulate import (
    accumulate_groups,
    accumulate_groups_fused,
)
from lfbm5d_torch.kernels.extract import extract_groups
from lfbm5d_torch.kernels.fused import MAX_SMEM, group_smem_bytes
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import build_kernel_step, resolve_route
from lfbm5d_torch.transforms import flat as tflat

torch.set_num_threads(2)

K, ND = 8, 2
SK, NSEL = K + 2 * ND, 2 * ND + 1
C_ANG = ND * NSEL + ND


@pytest.fixture(scope="module")
def case():
    """tests/test_kernels.py's fixture, with the port's constraints: one
    disparity per (position, SAI), so slot positions are distinct within a
    tile; the reference SAI's lane holds the centre; masked slots carry the
    sentinel (the reference extracts zeros for them)."""
    rng = np.random.default_rng(0)
    n_t, planes, bh, bw, l = 2, 2, 28, 32, 12  # l = A = 3x4 SAIs
    n_c, sc, ref = 2, 8, 5
    bands = rng.random((n_t * planes, bh, bw, l)) * 255.0
    cells = [(y, x) for y in range(bh - SK) for x in range(bw - SK)]
    pos = np.stack([
        np.asarray(cells)[rng.choice(len(cells), n_c * sc, replace=False)]
        for _ in range(n_t)
    ]).reshape(n_t, n_c, sc, 2).astype(np.int32)
    doff = rng.integers(0, NSEL**2, (n_t, n_c, sc, l)).astype(np.int32)
    doff[..., ref] = C_ANG
    mask = rng.random((n_t, n_c, sc)) > 0.25
    return dict(bands=bands, sy=pos[..., 0], sx=pos[..., 1], doff=doff,
                mask=mask, ref=ref, planes=planes)


def _port_inputs(cs, t):
    """Tile t of the case on the port's layout: planes [P, A, BH, BW] and
    the argmin maps that give each slot its disparity indices."""
    p, bands = cs["planes"], cs["bands"]
    planes = torch.as_tensor(bands[t * p:(t + 1) * p].transpose(0, 3, 1, 2))
    _, a, bh, bw = planes.shape
    bidx = np.full((a, bh - K + 1, bw - K + 1), C_ANG, np.int32)
    sim_y = cs["sy"][t] + ND
    sim_x = cs["sx"][t] + ND
    for g in range(sim_y.shape[0]):
        for n in range(sim_y.shape[1]):
            bidx[:, sim_y[g, n], sim_x[g, n]] = cs["doff"][t, g, n]
    return (planes.contiguous(), torch.as_tensor(bidx),
            torch.as_tensor(sim_y), torch.as_tensor(sim_x),
            torch.as_tensor(cs["mask"][t]))


def _ref_doff(cs):
    return np.where(cs["mask"][..., None], cs["doff"], NSEL**2)


def test_extract_equals_reference_interpret(case):
    cs = case
    n_t, p = cs["sy"].shape[0], cs["planes"]
    want = np.asarray(j_extract(
        jnp.asarray(cs["bands"]), jnp.asarray(cs["sy"]), jnp.asarray(cs["sx"]),
        jnp.asarray(_ref_doff(cs)), K, ND, planes=p, interpret=True,
    ))  # [n_t*planes, n_c, sc*k*k, L]
    for t in range(n_t):
        planes, bidx, sim_y, sim_x, mask = _port_inputs(cs, t)
        got = extract_groups(planes, bidx, sim_y, sim_x, mask, cs["ref"], k=K,
                             nd=ND)
        assert got.shape == (p, *sim_y.shape, K * K, planes.shape[1])
        w = want[t * p:(t + 1) * p].reshape(got.shape)
        np.testing.assert_array_equal(got.numpy(), w)
    assert extract_groups.launches == 0


def _bands_to_planes(x, t, p):
    return x[t * p:(t + 1) * p].transpose(0, 3, 1, 2)


def test_accumulate_equals_reference_interpret(case):
    cs = case
    n_t, n_c, sc = cs["sy"].shape
    p, l = cs["planes"], cs["bands"].shape[-1]
    bh, bw = cs["bands"].shape[1:3]
    rng = np.random.default_rng(1)
    m = cs["mask"][:, None, :, :, None, None]  # masked slots carry zeros
    vals = rng.random((n_t, p, n_c, sc, K * K, l)) * m
    wv = rng.random((n_t, p, n_c, sc)) * cs["mask"][:, None]
    kaiser = np.asarray(jm.kaiser_window(K))
    args = (jnp.asarray(cs["sy"]), jnp.asarray(cs["sx"]),
            jnp.asarray(_ref_doff(cs)), bh, bw, K, ND)
    j_vals = jnp.asarray(vals.reshape(n_t * p, n_c, sc * K * K, l))
    want_n = np.asarray(j_accumulate(j_vals, *args, planes=p,
                                     interpret=True))
    fn, fd = j_accumulate_fused(
        j_vals, jnp.asarray(wv.reshape(n_t * p, n_c, sc)), kaiser, *args,
        planes=p, interpret=True)
    want_fn, want_fd = np.asarray(fn), np.asarray(fd)
    kai = torch.as_tensor(kaiser.reshape(-1))
    for t in range(n_t):
        planes, bidx, sim_y, sim_x, mask = _port_inputs(cs, t)
        v = torch.as_tensor(vals[t])
        num = torch.zeros_like(planes)
        accumulate_groups(v, bidx, sim_y, sim_x, mask, cs["ref"], num, k=K,
                          nd=ND)
        np.testing.assert_allclose(num.numpy(),
                                   _bands_to_planes(want_n, t, p),
                                   rtol=0, atol=1e-12)
        num.zero_()
        den = torch.zeros_like(planes)
        accumulate_groups_fused(v, torch.as_tensor(wv[t]), kai, bidx, sim_y,
                                sim_x, mask, cs["ref"], num, den, k=K, nd=ND)
        np.testing.assert_allclose(num.numpy(),
                                   _bands_to_planes(want_fn, t, p),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(den.numpy(),
                                   _bands_to_planes(want_fd, t, p),
                                   rtol=0, atol=1e-12)
    assert accumulate_groups.launches == accumulate_groups_fused.launches == 0


@pytest.mark.parametrize("a_h,a_w", [(3, 3), (17, 17), (3, 5)])
@pytest.mark.parametrize("tau_4d", ["dct", "id"])
def test_flat_transforms_match_jax(a_h, a_w, tau_4d):
    sp = StepParams(n_sim=8, k=8, tau_4d=tau_4d)
    a = a_h * a_w
    rng = np.random.default_rng(a)
    g = rng.standard_normal((4, 8, 64, a)) * 50.0
    lvl = np.array([0, 1, 2, 3], np.int32)
    jft = jflat.FlatTransforms.build(sp, a_h, a_w, l=a, dtype=jnp.float64)
    tft = tflat.FlatTransforms.build(from_reference(sp), a_h, a_w,
                                     dtype=torch.float64)
    jf = np.asarray(jflat.forward_flat(jnp.asarray(g), jnp.asarray(lvl), jft))
    tf = tflat.forward_flat(torch.as_tensor(g), torch.as_tensor(lvl).long(),
                            tft)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-12)
    ji = np.asarray(jflat.inverse_flat(jnp.asarray(jf), jnp.asarray(lvl),
                                       jft))
    ti = tflat.inverse_flat(tf, torch.as_tensor(lvl).long(), tft)
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=1e-12)


ROUTE_CASES = [
    ("matched", 9, 9, {}, "fused"),
    ("default", 9, 9, {}, "banked"),
    ("robust", 9, 9, {}, "banked"),
    ("matched", 17, 17, {}, "banked"),
    ("matched", 19, 19, {}, "banked"),
    ("matched", 24, 16, {}, "two_kernel"),
    ("matched", 20, 20, {}, "two_kernel"),
    ("matched", 9, 9, dict(k=4), "two_kernel"),
    ("matched", 9, 9, dict(use_sd=True), "two_kernel"),
    ("default", 17, 17, dict(n_sim=32), "two_kernel"),
]


@pytest.mark.parametrize("preset,a_h,a_w,over,route", ROUTE_CASES)
def test_routes(preset, a_h, a_w, over, route):
    sp = tcfg.preset_step_params(preset, 2500.0, **over)
    assert resolve_route(sp, a_h, a_w) == route
    step = build_kernel_step(sp, 2.7, a_h, a_w, 24, 24, 1, False, "float32",
                             "cpu")
    assert step.route == route
    assert resolve_route(sp, a_h, a_w, fused=False) == "two_kernel"
    if route == "two_kernel":
        with pytest.raises(ValueError, match="fused=True"):
            resolve_route(sp, a_h, a_w, fused=True)
    else:
        assert resolve_route(sp, a_h, a_w, fused=True) == route


def test_group_smem_bytes():
    assert 160_000 < group_smem_bytes(8, 81, 9, 9) <= MAX_SMEM
    assert group_smem_bytes(16, 81, 9, 9) > MAX_SMEM
    assert group_smem_bytes(8, 289, 17, 17) > MAX_SMEM
    # group [64][(N*A)|1], tables, origins: N=4, A=9 at 3x3
    assert group_smem_bytes(4, 9, 3, 3) == 4 * (
        64 * 37 + 3 * 64 + 2 * 18 + 2 * 3 * 16 + 2 * 36)


# test_engine.py's tiny params at 12x12 (k=4: the two-kernel route for any
# `fused`), with p_ang=3 (25 reference SAIs instead of 144) to keep the
# gate fast; the 17x17 cases run k=8, so `fused=None` takes the banked route.
TINY_K4 = dict(n_sim=4, n_search=2, n_disp=1, k=4, p=3, p_ang=3)
TINY_K8 = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3, p_ang=4)
STEP_CASES = {
    "12x12-k4-ht": (12, 14, TINY_K4, False, [None]),
    "12x12-k4-wiener": (12, 14, TINY_K4, True, [False]),
    "17x17-ht": (17, 12, TINY_K8, False, [None, False]),
    "17x17-wiener": (17, 12, TINY_K8, True, [None, False]),
    "17x17-sd": (17, 12, dict(TINY_K8, use_sd=True), False, [None]),
    "9x9-n16-wiener": (9, 16, dict(TINY_K8, n_sim=16), True, [None]),
}
STEP_RUNS = [(case, fused) for case, v in STEP_CASES.items()
             for fused in v[-1]]


@pytest.fixture(scope="module")
def step_ref():
    """Per case: the step's inputs and the reference `_build_step` num/den
    (computed once, shared by both routes)."""
    lfs, out = {}, {}

    def get(case):
        if case in out:
            return out[case]
        a_h, h, over, wiener, _ = STEP_CASES[case]
        if (a_h, h) not in lfs:
            clean = synthetic_lf(a_h, a_h, h, h, channels=1, seed=0)
            lfs[a_h, h] = (add_noise_np(clean, 20.0, seed=1), clean
                           + add_noise_np(np.zeros_like(clean), 3.0, seed=2))
        noisy, basic = lfs[a_h, h]
        sp = StepParams(tau_match=400.0 if wiener else 2500.0, **over)
        lam = 0.0 if wiener else 2.7
        xp = tden._flat_pad(torch.as_tensor(noisy), sp.pad)
        bp = tden._flat_pad(torch.as_tensor(basic), sp.pad) if wiener else None
        mp = bp if wiener else xp
        sig = tden._sigma_channels(20.0, "rgb", 1, "float64")
        jstep = jden._build_step(sp, lam, a_h, a_h, h, h, 1, 64, wiener,
                                 "float64")
        jn, jd = jstep(jnp.asarray(xp.numpy()), jnp.asarray(mp.numpy()),
                       jnp.asarray(sig.numpy()),
                       None if bp is None else jnp.asarray(bp.numpy()))
        out[case] = (sp, lam, (xp, mp, sig, bp), np.asarray(jn),
                     np.asarray(jd))
        return out[case]

    return get


@pytest.mark.parametrize("case,fused", STEP_RUNS,
                         ids=[f"{c}-{'auto' if f is None else 'two_kernel'}"
                              for c, f in STEP_RUNS])
def test_step_num_den_match_reference(step_ref, case, fused):
    a_h, h, over, wiener, _ = STEP_CASES[case]
    sp, lam, inputs, jnum, jden_ = step_ref(case)
    step = build_kernel_step(from_reference(sp), lam, a_h, a_h, h, h, 1,
                             wiener, "float64", "cpu", fused=fused)
    want_route = "two_kernel" if (fused is False or over["k"] != 8
                                  or over.get("use_sd")) else "banked"
    assert step.route == want_route
    num, den = step(*inputs)
    np.testing.assert_allclose(num.numpy(), jnum, rtol=0, atol=1e-9)
    np.testing.assert_allclose(den.numpy(), jden_, rtol=0, atol=1e-9)
    assert (den.numpy() > 0).any()


def test_two_kernel_chunks_do_not_change_the_step(monkeypatch):
    """Chunking the groups (a device-memory budget) changes nothing."""
    from lfbm5d_torch.pipeline import engine

    sp = tcfg.StepParams(**dict(TINY_K4, p_ang=1))
    clean = synthetic_lf(3, 3, 20, 20, channels=2, seed=3)
    xp = tden._flat_pad(torch.as_tensor(add_noise_np(clean, 20.0, seed=4)),
                        sp.pad)
    sig = tden._sigma_channels(20.0, "rgb", 2, "float64")
    args = (sp, 2.7, 3, 3, 20, 20, 2, False, "float64", "cpu")
    num0, den0 = build_kernel_step(*args, fused=False)(xp, xp, sig, None)
    group = 2 * 4 * 16 * 9 * 8  # bytes of one group of both channels
    monkeypatch.setattr(engine, "TWO_KERNEL_CHUNK_BYTES", 3 * group)
    chunked = engine.build_kernel_step.__wrapped__(*args, fused=False)
    num1, den1 = chunked(xp, xp, sig, None)
    np.testing.assert_allclose(num1.numpy(), num0.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(den1.numpy(), den0.numpy(), rtol=0,
                               atol=1e-12)


def test_matched_17x17_rgb_matches_jax_xla():
    """The config-5 angular grid at the matched preset (p_ang subsampling,
    flat_tau, OPP) through the whole pipeline (banked route)."""
    params = preset_denoise_params("matched", 25.0)
    clean = synthetic_lf(17, 17, 16, 16, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(clean, 25.0, seed=100)
    jb, jf = j_run_bm5d(noisy, params, dtype="float64", engine="xla")
    tb, tf = run_bm5d(noisy, from_reference(params), dtype="float64",
                      engine="auto", device="cpu")
    assert np.abs(tb.numpy() - np.asarray(jb)).max() < 1e-9
    assert np.abs(tf.numpy() - np.asarray(jf)).max() < 1e-9


def test_fused_selects_routes_only_on_auto():
    params = tcfg.DenoiseParams()
    x = np.zeros((2, 2, 8, 8, 1))
    with pytest.raises(ValueError, match="fused"):
        run_bm5d(x, params, engine="torch", device="cpu", fused=False)
    with pytest.raises(ValueError, match="fused=True"):
        run_bm5d(x, params.replace(ht=params.ht.replace(k=4)),
                 device="cpu", fused=True)


def test_wrappers_raise_off_cpu_without_cuda():
    """A non-CPU tensor never falls back to a plain version."""
    from lfbm5d_torch.kernels.fused import GroupTables, fused_group_step_banked

    meta = torch.empty((3, 289, 40, 40), device="meta")
    i32 = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        extract_groups(meta, i32, i32, i32, i32, 0, k=8, nd=1)
    with pytest.raises(ValueError, match="CUDA"):
        accumulate_groups(meta, i32, i32, i32, i32, 0, meta, k=8, nd=1)
    with pytest.raises(ValueError, match="CUDA"):
        accumulate_groups_fused(meta, i32, meta, i32, i32, i32, i32, 0, meta,
                                meta, k=8, nd=1)
    sp = tcfg.preset_step_params("matched", 2500.0)
    tables = GroupTables.build(sp, 17, 17, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_group_step_banked(meta, None, meta, i32, i32, i32, i32, 0, meta,
                                tables, meta, meta, k=8, nd=1, lambda_3d=2.7,
                                wiener=False)


def test_wrappers_launch_on_their_tensors_device(monkeypatch):
    """Every kernel wrapper makes its library call (the launch and, for the
    group kernels, launch_groups' host calls) inside
    torch.cuda.device(<its tensors' device>), not on whatever device is
    current. Meta tensors stand in for CUDA ones; the library records the
    device entered at each call."""
    from lfbm5d_torch.kernels import accumulate, bm, extract, fused, gather
    from lfbm5d_torch.kernels.fused import (
        GroupTables, fused_group_step, fused_group_step_banked,
    )

    entered, calls = [], []

    class Device:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            entered.pop()

    class Library:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, entered[-1] if entered else None))
                return 0
            return call

    monkeypatch.setattr(torch.cuda, "device", Device)
    wrappers = (bm.self_distances_kernel, bm.cross_argmin_all_kernel,
                fused_group_step, fused_group_step_banked,
                extract.extract_groups, accumulate.accumulate_groups_fused,
                accumulate.accumulate_groups, gather.gather_rows)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    for mod in (bm, extract, accumulate, fused, gather):
        monkeypatch.setattr(mod, "library", Library)
        monkeypatch.setattr(mod, "stream_of", lambda t: None)
        monkeypatch.setattr(mod, "require", lambda *a, **kw: None)

    dev = torch.device("meta")
    f32, i32 = torch.float32, torch.int32
    k, nd, a, hp, wp, g, n = 8, 1, 9, 24, 24, 2, 4

    def t(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    planes, bidx = t(3, a, hp, wp), t(a, hp - k + 1, wp - k + 1, dtype=i32)
    sy, sx = t(g, n, dtype=i32), t(g, n, dtype=i32)
    mask = t(g, n, dtype=torch.bool)
    vals, wv = t(3, g, n, k * k, a), t(3, g, n)
    tables = GroupTables.build(tcfg.preset_step_params("matched", 2500.0),
                               3, 3, device=dev)
    lvl, sig = t(g, dtype=i32), t(3)
    group_args = (planes, None, bidx, sy, sx, lvl, mask, 0, sig, tables,
                  t(3, a, hp, wp), t(3, a, hp, wp))
    group_kw = dict(k=k, nd=nd, lambda_3d=2.7, wiener=False)
    launches = [
        ("lfbm5d_self_distances", lambda: bm.self_distances_kernel(
            planes[0, 0], [0, 8], [0, 8], k, 4)),
        ("lfbm5d_cross_argmin", lambda: bm.cross_argmin_all_kernel(
            planes[0, 0], planes[0], k, nd)),
        ("lfbm5d_group_step",
         lambda: fused_group_step(*group_args, **group_kw)),
        ("lfbm5d_group_step_banked",
         lambda: fused_group_step_banked(*group_args, **group_kw)),
        ("lfbm5d_extract_groups", lambda: extract.extract_groups(
            planes, bidx, sy, sx, mask, 0, k=k, nd=nd)),
        ("lfbm5d_accumulate_groups", lambda: accumulate.accumulate_groups(
            vals, bidx, sy, sx, mask, 0, planes, k=k, nd=nd)),
        ("lfbm5d_accumulate_groups",
         lambda: accumulate.accumulate_groups_fused(
             vals, wv, t(k * k), bidx, sy, sx, mask, 0, planes,
             t(3, a, hp, wp), k=k, nd=nd)),
        ("lfbm5d_gather_rows", lambda: gather.gather_rows(
            t(50, a, dtype=i32), t(g * n, dtype=i32))),
    ]
    for name, launch in launches:
        launch()
        assert calls[-1] == (name, dev), name
        assert not entered
    assert [w.launches for w in wrappers] == [1] * len(wrappers)
