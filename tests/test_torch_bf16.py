"""The bfloat16 transform chain (engine 'auto_bf16', the counterpart of the
reference's 'pallas_bf16') on the CPU: the port's plain bf16 group step
against the reference's bf16 kernel step (Pallas in interpret mode), the
whole pipeline against the reference's `pallas_bf16`, the rounding points
against a numpy emulation, the f32 fall-through beyond 128 SAIs, the entry
points, and the bf16 wrappers' launches.

Two correct bf16 chains do not agree element by element (their roundings
land differently and HT thresholds amplify each flip), and the port rounds
the 1-D factors of the spatial and angular tables where the reference rounds
their dense krons (transforms/apply.py): steps are held by relative L2 and
the pipeline by PSNR and RMSE, each against a bound stated beside its
measured value."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import DenoiseParams, StepParams
from lfbm5d_tpu.lf import psnr as np_psnr
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.synth import synthetic_lf_multi
from lfbm5d_tpu.pipeline import run_bm5d as j_run_bm5d
from lfbm5d_tpu.pipeline.engine import build_kernel_step as j_kernel_step
from lfbm5d_tpu.transforms import matrices as jm
from lfbm5d_torch import LFDenoiser, run_bm5d, run_sr
from lfbm5d_torch.config import SRParams, from_reference
from lfbm5d_torch.kernels import fused as kf
from lfbm5d_torch.ops.shrinkage import filter_groups
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import build_kernel_step
from lfbm5d_torch.pipeline.streaming import denoise_batch
from lfbm5d_torch.transforms.apply import (
    GroupTransforms,
    forward_5d,
    inverse_5d,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
AH, AW, H, W, C = 3, 3, 24, 32, 3
SIGMA = 25.0
TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)
# case -> (step params, Wiener, bound on the relative L2 of num and den
# against the reference's bf16 step; measured on the CPU: ht 1.5e-3 /
# 1.4e-3, wiener 6.0e-4 / 4.7e-4, ht-dct-stack 1.2e-3 / 1.0e-3, ht-sd
# (two_kernel route) 2.8e-3 / 2.5e-3)
STEP_CASES = {
    "ht": (StepParams(tau_match=2500.0, **TINY), False, 3e-3),
    "wiener": (StepParams(tau_match=400.0, **TINY), True, 3e-3),
    "ht-dct-stack": (StepParams(tau_match=2500.0, tau_5d="dct", **TINY),
                     False, 3e-3),
    "ht-sd": (StepParams(tau_match=2500.0, n_sim=4, n_search=3, n_disp=1,
                         k=8, p=4, use_sd=True), False, 5e-3),
}
# the port's f32 step must sit at least this much farther from the
# reference's bf16 step than its bf16 step does (measured 5.5-16x)
CHAIN_SEPARATION = 4.0
PSNR_TOL_DB = 0.01
RMSE_MAX = 1.0  # the reference's own bf16-vs-f32 RMSE on this LF: 0.685


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def step_lf():
    """Half-flat content, as tests/test_torch_group.py's."""
    clean = synthetic_lf_multi(AH, AW, H, W, C, disps=(0.0, 2.0), seed=0,
                               blob_frac=0.25, flat_frac=0.4)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    return noisy, clean + add_noise_np(np.zeros_like(clean), 3.0, seed=2)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_plain_bf16_step_matches_reference_bf16(step_lf, case):
    """(a) num/den of the port's kernel step with chain bf16 (the group
    kernels' plain version, or the two-kernel route's flat chain for
    use_sd) against the reference's build_kernel_step(group_dtype=
    'bfloat16') in interpret mode, f32."""
    sp, wiener, bound = STEP_CASES[case]
    lam = 0.0 if wiener else 2.7
    noisy, basic = step_lf
    f32 = torch.float32
    xp = tden._flat_pad(torch.as_tensor(noisy, dtype=f32), sp.pad)
    bp = (tden._flat_pad(torch.as_tensor(basic, dtype=f32), sp.pad)
          if wiener else None)
    mp = bp if wiener else xp
    sig = tden._sigma_channels(SIGMA, "rgb", C, "float32")
    got = {}
    for chain in (BF16, None):
        step = build_kernel_step(from_reference(sp), lam, AH, AW, H, W, C,
                                 wiener, "float32", "cpu", chain_dtype=chain)
        assert step.chain == chain
        got[chain] = [x.numpy() for x in step(xp, mp, sig, bp)]
    jstep = j_kernel_step(sp, lam, AH, AW, H, W, C, wiener, "float32",
                          interpret=True, group_dtype="bfloat16")
    want = [np.asarray(x) for x in jstep(
        jnp.asarray(xp.numpy()), jnp.asarray(mp.numpy()),
        jnp.asarray(sig.numpy()),
        None if bp is None else jnp.asarray(bp.numpy()))]
    for i, name in enumerate(("num", "den")):
        rel = _rel(got[BF16][i], want[i])
        assert rel <= bound, (name, rel)
        assert _rel(got[None][i], want[i]) >= CHAIN_SEPARATION * rel, name


@pytest.fixture(scope="module")
def pipeline_runs():
    """(b) The probe LF through the reference's pallas / pallas_bf16 and the
    port's auto / auto_bf16 (CPU): {engine: final}, and the clean LF."""
    clean = synthetic_lf(3, 3, 24, 32, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    params = DenoiseParams(sigma=SIGMA,
                           ht=StepParams(tau_match=2500.0, **TINY),
                           wiener=StepParams(tau_match=400.0, **TINY))
    finals = {}
    for eng in ("pallas", "pallas_bf16"):
        finals[eng] = np.asarray(j_run_bm5d(noisy, params, engine=eng)[1])
    for eng in ("auto", "auto_bf16"):
        finals[eng] = run_bm5d(noisy, from_reference(params), engine=eng,
                               device="cpu")[1].numpy()
    return finals, clean


def _final_psnr(final, clean):
    return np_psnr(np.clip(final, 0.0, 255.0), clean)


@pytest.mark.parametrize("against", ["pallas_bf16", "auto"])
def test_run_bm5d_bf16_psnr(pipeline_runs, against):
    """(b) Final PSNR of auto_bf16 within 0.01 dB of the reference's
    pallas_bf16 (measured 26.7132 vs 26.7087 dB) and of the port's f32
    (26.7070 dB)."""
    finals, clean = pipeline_runs
    got = _final_psnr(finals["auto_bf16"], clean)
    assert abs(got - _final_psnr(finals[against], clean)) <= PSNR_TOL_DB


def test_run_bm5d_bf16_rmse_to_reference(pipeline_runs):
    """(b) RMSE between the two bf16 outputs <= 1.0 (measured 0.166); the
    chain is on: the port's bf16 and f32 outputs differ."""
    finals, _ = pipeline_runs
    d = finals["auto_bf16"].astype(np.float64) - finals["pallas_bf16"]
    assert float(np.sqrt(np.mean(d * d))) <= RMSE_MAX
    assert not np.array_equal(finals["auto_bf16"], finals["auto"])


@pytest.fixture(scope="module")
def flagship_cut():
    """The flagship's content and preset (`matched`, two-plane LF, synth
    seed 0, noise seed 1) at 9x9x32x48 through the reference's pallas /
    pallas_bf16 and the port's auto / auto_bf16 (CPU): {engine: (final
    PSNR, mean of final - clean)}."""
    from lfbm5d_tpu.config import preset_denoise_params

    clean = synthetic_lf(9, 9, 32, 48, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(clean, SIGMA, seed=1)
    params = preset_denoise_params("matched", SIGMA)
    finals = {eng: np.asarray(j_run_bm5d(noisy, params, engine=eng)[1])
              for eng in ("pallas", "pallas_bf16")}
    for eng in ("auto", "auto_bf16"):
        finals[eng] = run_bm5d(noisy, from_reference(params), engine=eng,
                               device="cpu")[1].numpy()
    return {eng: (_final_psnr(f, clean), float(np.mean(f - clean)))
            for eng, f in finals.items()}


def test_bf16_psnr_at_9x9_matches_reference(flagship_cut):
    """At 9x9 the chain costs PSNR in the reference itself (measured:
    pallas_bf16 26.9811 dB against pallas 26.9941); auto_bf16 lands within
    0.01 dB of pallas_bf16 (measured 26.9869)."""
    got, want = flagship_cut["auto_bf16"][0], flagship_cut["pallas_bf16"][0]
    assert abs(got - want) <= PSNR_TOL_DB


def test_bf16_mean_shift_at_9x9_matches_reference(flagship_cut):
    """The chain's gain on the mean (the bf16-rounded DC entries of the
    angular DCT) moves the final's mean by as much as the reference's does:
    within 20% (measured +0.589 against the reference's +0.654); rounded
    1-D angular factors would double it."""
    shift = {side: flagship_cut[b][1] - flagship_cut[f][1]
             for side, (b, f) in (("port", ("auto_bf16", "auto")),
                                  ("ref", ("pallas_bf16", "pallas")))}
    assert abs(shift["port"] - shift["ref"]) <= 0.2 * shift["ref"]


def _bf16(x):
    """numpy emulation of the chain's rounding: float32, then round to
    nearest even at 16 bits (bfloat16), back as float64."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _emulate(g, lvl, sp, a_h, a_w, gb=None, sigma=None, lam=2.7):
    """Step-by-step numpy forward chain, shrink (HT, or Wiener with gb),
    inverse chain, at the rounding points of transforms/apply.py; tables
    from the reference's matrices: the spatial 1-D factors and the dense
    angular kron rounded."""
    f2, i2 = map(_bf16, jm.transform_pair(sp.tau_2d, sp.k))
    f4s, i4s = jm.transform_pair(sp.tau_4d, a_h)
    f4t, i4t = jm.transform_pair(sp.tau_4d, a_w)
    f4, i4 = _bf16(np.kron(f4s, f4t)), _bf16(np.kron(i4s, i4t))
    sf, si = jm.stack_matrices(sp.tau_5d, sp.n_sim)
    if sp.tau_5d == "dct":
        sf, si = _bf16(sf), _bf16(si)

    def ang(m, x):
        y = np.einsum("qa,bnauvc->bnquvc", m, x.reshape(
            x.shape[0], x.shape[1], a_h * a_w, *x.shape[4:]))
        return _bf16(y.reshape(x.shape))

    def fwd(x):
        x = np.einsum("uq,bnstqvc->bnstuvc", f2, _bf16(x))
        x = _bf16(np.einsum("vq,bnstuqc->bnstuvc", f2, x))
        x = ang(f4, x)
        return _bf16(np.einsum("bnq,bqstuvc->bnstuvc", sf[lvl], x))

    def inv(x):
        x = _bf16(np.einsum("bnq,bqstuvc->bnstuvc", si[lvl], x))
        x = ang(i4, x)
        x = np.einsum("uq,bnstqvc->bnstuvc", i2, x)
        return _bf16(np.einsum("vq,bnstuqc->bnstuvc", i2, x))

    spec = fwd(g)
    if gb is None:
        filt = spec * (np.abs(spec) >= lam * sigma)
    else:
        b2 = fwd(gb) ** 2
        filt = _bf16(spec * (b2 / (b2 + sigma**2)))
    return spec, inv(spec), inv(filt)


@pytest.mark.parametrize("tau_5d", ["haar", "dct"])
@pytest.mark.parametrize("wiener", [False, True])
def test_chain_rounding_points_match_numpy(tau_5d, wiener):
    """(c) A random group through forward_5d, inverse_5d and filter_groups
    with the bf16 chain (float64 tensors) equals the numpy emulation: every
    value to 1e-9 absolute, which only absorbs float64 summation residue
    where coefficients cancel (one bf16 step at these magnitudes is above
    1e-3); the Haar stack tables stay unrounded, the DCT ones are
    rounded."""
    sp = from_reference(StepParams(tau_5d=tau_5d, **TINY))
    a_h, a_w, b = 3, 2, 4
    rng = np.random.default_rng(7)
    shape = (b, sp.n_sim, a_h, a_w, sp.k, sp.k, 2)
    g = rng.standard_normal(shape) * 60.0 + 120.0
    gb = g + rng.standard_normal(shape) * 5.0
    lvl = np.array([3, 2, 1, 0])
    sigma = np.array([25.0, 12.5])
    gt = GroupTransforms.build(sp, a_h, a_w, dtype=torch.float64, chain=BF16)
    t_lvl = torch.as_tensor(lvl)
    spec, back, est = _emulate(g, lvl, sp, a_h, a_w, gb if wiener else None,
                               sigma)
    t_spec = forward_5d(torch.as_tensor(g), t_lvl, gt)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)

    close(t_spec, spec)
    close(inverse_5d(torch.as_tensor(spec), t_lvl, gt), back)
    t_est, _ = filter_groups(torch.as_tensor(g),
                             torch.as_tensor(gb) if wiener else None, t_lvl,
                             gt, torch.as_tensor(sigma), 2.7, False)
    close(t_est, est)
    assert np.array_equal(_bf16(spec), spec)  # every stage output is bf16
    stack_rounded = np.array_equal(_bf16(gt.stack_f.numpy()),
                                   gt.stack_f.numpy())
    assert stack_rounded == (tau_5d == "dct")


def test_kernel_tables_carry_the_chain():
    """The bf16 GroupTables pack bf16-valued spatial factors and the f32
    Kaiser window, and hold the dense angular tables as the kernels read
    them (csrc/group_stage.cuh::angular_dense): the rounded kron of the
    two DCTs in bfloat16, zero padded to a multiple of 16; f32 tables have
    none."""
    sp = from_reference(StepParams(**TINY))
    t16 = kf.GroupTables.build(sp, 3, 5, chain=BF16)
    t32 = kf.GroupTables.build(sp, 3, 5)
    p16 = t16.packed
    head = p16[:64 + 64]  # f2, i2
    np.testing.assert_array_equal(head.numpy(), head.to(BF16).float().numpy())
    assert not torch.equal(head, t32.packed[:128])
    np.testing.assert_array_equal(p16[128:192].numpy(),
                                  t32.packed[128:192].numpy())
    assert t16.dense.shape == (2, 16, 16) and t32.dense is None
    assert t16.dense.dtype == BF16
    f4s, i4s = jm.transform_pair("dct", 3)
    f4t, i4t = jm.transform_pair("dct", 5)
    for d, m in zip(t16.dense, (np.kron(f4s, f4t), np.kron(i4s, i4t))):
        np.testing.assert_array_equal(d[:15, :15].float().numpy(),
                                      _bf16(m).astype(np.float32))
        assert not d[15:].any() and not d[:, 15:].any()
    assert t16.gt.chain == BF16 and t32.gt.chain is None


@pytest.mark.parametrize("n_sim", [8, 16])
def test_bf16_plan_holds_the_angular_table(n_sim):
    """The bf16 kernels' launch plan holds a bf16 slice (item rows of
    `item_stride(A)` values), the patch origins and both directions' shared
    angular tables (2 * KP rows of KP + 8 bf16, KP = A rounded up to 16,
    and 4 words of alignment); at 9x9 the cluster sizes stay those of the
    f32 chain."""
    for wiener in (False, True):
        f32 = kf.group_plan(n_sim, 9, 9, wiener)
        bf16 = kf.group_plan(n_sim, 9, 9, wiener, bf16=True)
        assert bf16[:2] == f32[:2]
        cs = bf16[0]
        slice_words = (2 if wiener else 1) * (64 // cs) * n_sim * 88 // 2
        origins = 2 * -(-n_sim * 81 // cs)
        assert bf16[2] == 4 * (slice_words + origins + 96 * 104 + 4)
    assert kf.table_words(128) == 128 * 136 + 4
    assert kf.table_words(1) == 16 * 24 + 4


def test_chain_mean_gain_is_the_references():
    """The chain's tables scale the mean (the DC path of a forward and
    inverse round trip) as the reference's dense bf16 tables do: at 9x9 the
    angular tables by 1.0039 (the DC entry 1/9 rounds 0.195% high, forward
    and inverse), where rounded 1-D factors (1/3, 0.195% high, squared)
    would give 1.0078; the spatial factors by 0.99957 (the reference's
    dense 1/8 is exact)."""
    sp = from_reference(StepParams(**TINY))
    gt = GroupTransforms.build(sp, 9, 9, dtype=torch.float64, chain=BF16)

    def dc_gain(f, i):
        return float((i @ (f @ torch.ones(f.shape[1], dtype=f.dtype)))[0])

    f9, i9 = jm.transform_pair("dct", 9)
    ref = (_bf16(np.kron(i9, i9)) @ (_bf16(np.kron(f9, f9)) @ np.ones(81)))
    assert abs(dc_gain(gt.f4, gt.i4) - ref[0]) < 1e-12
    assert abs(ref[0] - 1.0039) < 1e-4
    f9r, i9r = _bf16(f9), _bf16(i9)
    factor = (np.kron(i9r, i9r) @ (np.kron(f9r, f9r) @ np.ones(81)))[0]
    assert abs(factor - 1.0078) < 1e-4
    assert abs(dc_gain(gt.f2, gt.i2) ** 2 - 0.99957) < 1e-5


def _lf(a, h, w, c=1, seed=0):
    clean = synthetic_lf(a, a, h, w, channels=c, seed=seed)
    return add_noise_np(clean, 20.0, seed=seed + 1), clean


def _params(**over):
    step = dict(TINY, p_ang=4)
    step.update(over)
    return from_reference(DenoiseParams(
        sigma=20.0, ht=StepParams(tau_match=2500.0, **step),
        wiener=StepParams(tau_match=400.0, **step), chunk=32))


def test_auto_bf16_beyond_128_sais_is_the_f32_path():
    """(d) A 12x12 grid (144 SAIs) runs the f32 step itself under
    auto_bf16 (the same step object: route banked, no chain), so the same
    output as auto; float64, as the plain version's scatter-adds sum in no
    fixed order on the host (f32 runs differ by ~1e-4 run to run)."""
    noisy, _ = _lf(12, 16, 16)
    params = _params()
    steps = [tden._raw_step(params.ht, 2.7, 12, 12, 16, 16, 1, 32, False,
                            "float32", eng, "cpu")
             for eng in ("auto", "auto_bf16")]
    assert steps[0] is steps[1]
    assert steps[1].chain is None and steps[1].route == "banked"
    outs = [run_bm5d(noisy, params, dtype="float64", engine=eng,
                     device="cpu") for eng in ("auto", "auto_bf16")]
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)


def test_auto_bf16_refuses_two_kernel_route():
    """(d) fused=False with the chain raises, as the reference's
    group_dtype does without its fused engine; chain_dtype takes bf16
    only."""
    noisy, _ = _lf(2, 16, 16)
    with pytest.raises(ValueError, match="fused"):
        run_bm5d(noisy, _params(), engine="auto_bf16", device="cpu",
                 fused=False)
    with pytest.raises(ValueError, match="chain_dtype"):
        build_kernel_step(_params().ht, 2.7, 2, 2, 16, 16, 1, False,
                          "float32", "cpu", chain_dtype=torch.float16)


def _same(got, want):
    """Equal but for the host's scatter-add order (float64)."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9)


def _f64_run(lf, params, engine):
    return run_bm5d(lf, params, dtype="float64", engine=engine, device="cpu")


def test_denoise_batch_accepts_auto_bf16():
    """(e) denoise_batch runs the bf16 chain: each LF as run_bm5d's, which
    differs from the f32 chain's."""
    noisy, _ = _lf(2, 16, 20)
    params = _params()
    batch = np.stack([noisy, noisy[::-1].copy()])
    _, finals = denoise_batch(batch, params, devices=["cpu"],
                              dtype="float64", engine="auto_bf16")
    for i in range(2):
        _same(finals[i], _f64_run(batch[i], params, "auto_bf16")[1])
    f32 = _f64_run(batch[0], params, "auto")[1]
    assert float((finals[0] - f32).abs().max()) > 1e-3


def test_run_sr_accepts_auto_bf16():
    """(e) run_sr with the chain: close to the f32 SR, not equal to it."""
    _, clean = _lf(2, 12, 16, c=3)
    lr = clean[:, :, ::2, ::2]
    p = _params()
    sr = SRParams(scale=2, n_iter=2, sigma_init=8.0, sigma_final=2.0,
                  ht=p.ht, wiener=p.wiener, chunk=32)
    hr16 = run_sr(lr, sr, engine="auto_bf16", device="cpu")
    hr32 = run_sr(lr, sr, engine="auto", device="cpu")
    assert hr16.shape == (2, 2, 12, 16, 3)
    assert not torch.equal(hr16, hr32)
    assert float((hr16 - hr32).abs().mean()) < 1.0


def test_lf_denoiser_accepts_auto_bf16():
    """(e) LFDenoiser(engine='auto_bf16') is run_bm5d's bf16 chain."""
    noisy, _ = _lf(2, 16, 20)
    params = _params()
    basic, final = LFDenoiser(params, engine="auto_bf16", dtype="float64",
                              device="cpu")(noisy)
    wb, wf = _f64_run(noisy, params, "auto_bf16")
    _same(basic, wb)
    _same(final, wf)


def test_bf16_wrappers_launch_the_bf16_kernels(monkeypatch):
    """With a stand-in library (meta tensors for CUDA ones): the bf16
    wrappers pass bf16=1 to their entry points and count their own
    launches; the f32 wrappers pass 0; a wrapper refuses tables of the
    other chain; a failed launch raises (no fallback to the plain version
    or the f32 kernel)."""
    calls, rcs = [], []

    class Library:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args[-3]))  # bf16 precedes lambda
                return rcs.pop() if rcs else 0
            return call

    class Device:
        def __init__(self, dev):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(kf, "library", Library)
    monkeypatch.setattr(kf, "stream_of", lambda t: None)
    monkeypatch.setattr(kf, "require", lambda *a, **kw: None)
    monkeypatch.setattr(kf, "check", lambda rc, what: (_ for _ in ()).throw(
        RuntimeError(f"{what}: CUDA error {rc}")))
    wrappers = (kf.fused_group_step, kf.fused_group_step_banked,
                kf.fused_group_step_bf16, kf.fused_group_step_banked_bf16)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    dev = torch.device("meta")
    i32 = torch.int32
    a, hp, wp, g, n = 9, 24, 24, 2, 8

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    sp = from_reference(StepParams(**TINY))
    tables = {chain: kf.GroupTables.build(sp, 3, 3, device=dev, chain=chain)
              for chain in (None, BF16)}

    def launch(w, chain):
        w(t(3, a, hp, wp), None, t(a, hp - 7, wp - 7, dtype=i32),
          t(g, n, dtype=i32), t(g, n, dtype=i32), t(g, dtype=i32),
          t(g, n, dtype=torch.bool), 0, t(3), tables[chain],
          t(3, a, hp, wp), t(3, a, hp, wp), k=8, nd=1, lambda_3d=2.7,
          wiener=False)

    for w, chain in zip(wrappers, (None, None, BF16, BF16)):
        launch(w, chain)
    assert calls == [("lfbm5d_group_step", 0),
                     ("lfbm5d_group_step_banked", 0),
                     ("lfbm5d_group_step", 1),
                     ("lfbm5d_group_step_banked", 1)]
    assert [w.launches for w in wrappers] == [1, 1, 1, 1]
    with pytest.raises(ValueError, match="chain"):
        launch(kf.fused_group_step_bf16, None)
    with pytest.raises(ValueError, match="chain"):
        launch(kf.fused_group_step, BF16)
    rcs.append(700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch(kf.fused_group_step_bf16, BF16)
    assert [w.launches for w in wrappers] == [1, 1, 1, 1]
