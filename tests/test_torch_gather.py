"""The row gather and the kernel step's disparity-sampling modes (CPU).

`gather_rows_plain` against the reference's Pallas `gather_rows` in
interpret mode (whose table must be lane-aligned: narrower tables are padded
to 128 lanes for it, as its callers do), and the kernel step's `direct`,
`take` and `dma` modes against each other (bit for bit in float64) and
against the dense plain step, on every route."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.kernels.gather import gather_rows as j_gather_rows
from lfbm5d_torch import config as tcfg
from lfbm5d_torch.kernels.gather import gather_rows, gather_rows_plain
from lfbm5d_torch.lf import add_noise_np, synthetic_lf
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import DOFF_MODES, build_kernel_step

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("w", [81, 128, 300])
def test_gather_rows_plain_equals_reference_interpret(dtype, w):
    rng = np.random.default_rng(w)
    v, s = 300, 77  # S a multiple of neither s_chunk (64) nor depth (16)
    if dtype == np.int32:
        table = rng.integers(-1000, 1000, (v, w)).astype(dtype)
    else:
        table = rng.standard_normal((v, w)).astype(dtype)
    idx = rng.integers(0, v, (s,)).astype(np.int32)
    lanes = -(-w // 128) * 128
    padded = np.pad(table, ((0, 0), (0, lanes - w)))
    want = np.asarray(j_gather_rows(jnp.asarray(padded), jnp.asarray(idx),
                                    s_chunk=64, interpret=True))[:, :w]
    t, i = torch.as_tensor(table), torch.as_tensor(idx)
    got = gather_rows(t, i)
    assert got.dtype == t.dtype and got.shape == (s, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather_rows_plain(t, i).numpy(), want)
    assert gather_rows.launches == 0


def test_gather_rows_plain_raises_out_of_range():
    table = torch.zeros((10, 81), dtype=torch.int32)
    with pytest.raises((IndexError, RuntimeError)):
        gather_rows_plain(table, torch.tensor([3, 10], dtype=torch.int32))


def test_gather_rows_raises_off_cpu_without_cuda():
    """A non-CPU tensor never falls back to the plain version."""
    table = torch.empty((10, 81), dtype=torch.int32, device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows(table, idx)
    with pytest.raises(ValueError, match="int32 or float32"):
        gather_rows(table.to(torch.int64), idx)


# (angular side, spatial side, fused): 3x3 at k=8 takes the shared-memory
# group kernel, 12x12 the banked one (its group exceeds shared memory), and
# fused=False the two-kernel route on both.
MODE_CASES = {
    "3x3-fused": (3, 20, None, "fused"),
    "3x3-two_kernel": (3, 20, False, "two_kernel"),
    "12x12-banked": (12, 14, None, "banked"),
    "12x12-two_kernel": (12, 14, False, "two_kernel"),
}
TINY = dict(n_sim=8, n_search=4, n_disp=1, k=8, p=3)


@pytest.fixture(scope="module")
def mode_inputs():
    cache = {}

    def get(a, h, wiener):
        key = (a, h, wiener)
        if key not in cache:
            clean = synthetic_lf(a, a, h, h, channels=2, disp_bg=1,
                                 disp_fg=2, seed=a)
            sp = tcfg.StepParams(tau_match=400.0 if wiener else 2500.0,
                                 p_ang=1 if a == 3 else 4, **TINY)
            xp = tden._flat_pad(torch.as_tensor(
                add_noise_np(clean, 20.0, seed=1)), sp.pad)
            bp = tden._flat_pad(torch.as_tensor(
                clean + add_noise_np(np.zeros_like(clean), 3.0, seed=2)),
                sp.pad) if wiener else None
            sig = tden._sigma_channels(20.0, "rgb", 2, "float64", "cpu")
            lam = 0.0 if wiener else 2.7
            dense = tden._build_step(sp, lam, a, a, h, h, 2, 64, wiener,
                                     "float64", "cpu")
            args = (xp, bp if wiener else xp, sig, bp)
            cache[key] = (sp, lam, args, dense(*args))
        return cache[key]

    return get


@pytest.mark.parametrize("wiener", [False, True], ids=["ht", "wiener"])
@pytest.mark.parametrize("case", list(MODE_CASES))
def test_doff_modes_identical_on_every_route(mode_inputs, case, wiener):
    a, h, fused, route = MODE_CASES[case]
    sp, lam, args, (dnum, dden) = mode_inputs(a, h, wiener)
    out = {}
    for mode in DOFF_MODES:
        step = build_kernel_step(sp, lam, a, a, h, h, 2, wiener, "float64",
                                 "cpu", fused, mode)
        assert step.route == route
        out[mode] = step(*args)
    for mode in ("take", "dma"):
        assert torch.equal(out[mode][0], out["direct"][0]), mode
        assert torch.equal(out[mode][1], out["direct"][1]), mode
    num, den = out["direct"]
    np.testing.assert_allclose(num.numpy(), dnum.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(den.numpy(), dden.numpy(), rtol=0, atol=1e-9)
    assert (den.numpy() > 0).any()


def test_slot_table_rows_are_the_argmin_maps():
    """take/dma doff equals bidx sampled at every slot; direct has none."""
    sp = tcfg.StepParams(tau_match=2500.0, **TINY)
    clean = synthetic_lf(3, 3, 20, 20, channels=1, seed=5)
    xp = tden._flat_pad(torch.as_tensor(add_noise_np(clean, 20.0, seed=6)),
                        sp.pad)
    match0 = xp[..., 0].contiguous()
    steps = {m: build_kernel_step(sp, 2.7, 3, 3, 20, 20, 1, False, "float64",
                                  "cpu", None, m) for m in DOFF_MODES}
    sim_y, sim_x, _, _, bidx = steps["take"].block_match(match0, 4, None)
    assert steps["direct"].slot_table(bidx, sim_y, sim_x) is None
    want = bidx[:, sim_y.long(), sim_x.long()].permute(1, 2, 0)
    for mode in ("take", "dma"):
        doff = steps[mode].slot_table(bidx, sim_y, sim_x)
        assert doff.dtype == torch.int32 and doff.shape == (*sim_y.shape, 9)
        assert torch.equal(doff, want)


def test_doff_mode_pipeline_and_errors():
    params = tcfg.preset_denoise_params("matched", 25.0)
    clean = synthetic_lf(3, 3, 24, 24, channels=3, disp_bg=1, disp_fg=2,
                         seed=0)
    noisy = add_noise_np(clean, 25.0, seed=1)
    outs = [tden.run_bm5d(noisy, params, dtype="float64", device="cpu",
                          doff_mode=m) for m in DOFF_MODES]
    for basic, final in outs[1:]:
        assert torch.equal(basic, outs[0][0]) and torch.equal(final,
                                                              outs[0][1])
    with pytest.raises(ValueError, match="doff_mode"):
        tden.run_bm5d(noisy, params, engine="torch", device="cpu",
                      doff_mode="dma")
    with pytest.raises(ValueError, match="doff_mode"):
        tden.run_bm5d(noisy, params, device="cpu", doff_mode="gather")


def test_gather_rows_host_path(monkeypatch):
    """The wrapper's host path on stand-ins for CUDA tensors: it enters
    torch.cuda.device(<the tensors' card>) only where that card is not the
    current one, resolves the library's entry point once, and counts each
    launch."""
    from lfbm5d_torch.kernels import gather

    class Fake:
        def __init__(self, shape, dtype, device):
            self.shape, self.dtype = tuple(shape), dtype
            self.device = torch.device(device)

        def data_ptr(self):
            return 0

        def dim(self):
            return len(self.shape)

    entered, calls, resolved = [], [], []

    class Device:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            entered.pop()

    class Library:
        def __getattr__(self, name):
            resolved.append(name)

            def call(*args):
                calls.append((args[3:5], list(entered)))
                return 0
            return call

    lib = Library()
    monkeypatch.setattr(gather, "library", lambda: lib)
    monkeypatch.setattr(gather, "_entry", [None, None])
    monkeypatch.setattr(gather, "stream_of", lambda t: None)
    monkeypatch.setattr(gather, "require", lambda *a, **kw: None)
    monkeypatch.setattr(gather.gather_rows, "launches", 0)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device: Fake(
        shape, dtype, device))
    for card, s in ((0, 34760), (1, 7), (0, 1)):
        dev = f"cuda:{card}"
        out = gather_rows(Fake((300, 81), torch.int32, dev),
                          Fake((s,), torch.int32, dev))
        assert out.shape == (s, 81) and out.device == torch.device(dev)
    assert calls == [((34760, 81), []),
                     ((7, 81), [torch.device("cuda:1")]),
                     ((1, 81), [])]
    assert resolved == ["lfbm5d_gather_rows"] and not entered
    assert gather_rows.launches == 3
    # an empty gather launches nothing
    gather_rows(Fake((300, 81), torch.int32, "cuda:0"),
                Fake((0,), torch.int32, "cuda:0"))
    assert gather_rows.launches == 3 and len(calls) == 3
