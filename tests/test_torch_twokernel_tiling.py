"""The decomposition of the two-kernel path's CUDA kernels
(csrc/twokernel.cu: extract_kernel, accumulate_kernel), emulated on the CPU
in float32 and float64 and held to the plain versions at ragged shapes.

A block owns one (slot, plane) run [k*k, A] of the group tensor. It looks
the plane offset of every SAI's patch origin up once (the base table), then
moves the run through a shared stage [rows*k][pitch] chunk by chunk of whole
patch rows (`twokernel_plan`), the SAI axis in tiles where one row of every
SAI does not fit. Extract gathers patch rows into the stage and writes it
out in aligned 16-byte windows (float4 where a window lies whole inside the
run, scalars at its ragged ends); accumulate reads its run the same way and
adds it with one scalar reduction per value, consecutive threads on
consecutive pixels of one SAI. The emulation below follows that order and
checks its invariants: every element written or read exactly once, every
whole window aligned, the stage rows at their pitch."""

import numpy as np
import pytest
import torch

from lfbm5d_torch.kernels.accumulate import (
    accumulate_groups_fused_plain,
    accumulate_groups_plain,
)
from lfbm5d_torch.kernels.extract import extract_groups_plain, twokernel_plan
from lfbm5d_torch.ops.distances import center_index

torch.set_num_threads(2)


def windows(start: int, length: int):
    """(element offsets [nw, 4], valid [nw, 4], whole [nw]) of the aligned
    16-byte windows over a run of `length` floats at flat offset `start`
    (csrc/twokernel.cu::store_runs / load_runs: (length + 6) // 4 windows,
    the first starting start % 4 floats before the run)."""
    nw = (length + 6) // 4
    e = 4 * torch.arange(nw) - start % 4
    off = e[:, None] + torch.arange(4)
    valid = (off >= 0) & (off < length)
    whole = (e >= 0) & (e + 4 <= length)
    return off, valid, whole


def _store_runs(dst, dst0, src, src0, nrun, length, dstride, sstride):
    """dst[dst0 + r*dstride + i] = src[src0 + r*sstride + i], i < length,
    r < nrun, window by window over the runs of dst (the group tensor):
    whole windows 16-byte aligned, every element written once."""
    for r in range(nrun):
        g0, s0 = dst0 + r * dstride, src0 + r * sstride
        off, valid, whole = windows(g0, length)
        assert bool(((g0 + off[whole, 0]) % 4 == 0).all())
        assert int(valid[whole].sum()) == 4 * int(whole.sum())
        i = off[valid]
        assert sorted(i.tolist()) == list(range(length))
        dst[g0 + i] = src[s0 + i]


def _base_table(bidx, sim_y, sim_x, ref, s, a0, na, hp, wp, nd, doff):
    """Plane offsets of the patch origins of SAIs a0 .. a0+na-1 in slot s."""
    nsel = 2 * nd + 1
    sy, sx = int(sim_y[s]), int(sim_x[s])
    a = torch.arange(a0, a0 + na)
    d = (doff[s, a0:a0 + na] if doff is not None
         else bidx[a, sy, sx]).long().clone()
    d[a == ref] = center_index(nd)
    return (a * hp + sy + d // nsel - nd) * wp + sx + d % nsel - nd


def _runs(k, a, na, pitch, nr):
    """(runs, run length) of a chunk: one run when the stage rows follow
    each other as the group tensor's do, else one per pixel."""
    return (1, nr * k * a) if na == a and pitch == a else (nr * k, na)


def emulate_extract(planes, bidx, sim_y, sim_x, mask, ref, k, nd, plan,
                    doff=None, out_pad=0):
    """extract_kernel's order of work; the group tensor starts out_pad
    floats into its buffer (its runs' alignment)."""
    p_, a, hp, wp = planes.shape
    s_ = sim_y.numel()
    rows, tile, pitch, _ = plan
    kka = k * k * a
    src = planes.reshape(-1)
    out = torch.full((out_pad + p_ * s_ * kka,), float("nan"),
                     dtype=planes.dtype)
    sy, sx = sim_y.reshape(-1), sim_x.reshape(-1)
    flat_doff = None if doff is None else doff.reshape(s_, a)
    pix = torch.arange(rows * k)
    for s in range(s_):
        for p in range(p_):
            o = out_pad + (p * s_ + s) * kka
            if not bool(mask.reshape(-1)[s]):
                _store_runs(out, o, torch.zeros(kka, dtype=out.dtype), 0, 1,
                           kka, 0, 0)
                continue
            for a0 in range(0, a, tile):
                na = min(tile, a - a0)
                base = _base_table(bidx, sy, sx, ref, s, a0, na, hp, wp, nd,
                                   flat_doff)
                for r0 in range(0, k, rows):
                    nr = min(rows, k - r0)
                    stage = torch.full((rows * k * pitch,), float("nan"),
                                       dtype=planes.dtype)
                    pl = pix[:nr * k, None]
                    at = (p * a * hp * wp + base[None, :]
                          + (r0 + pl // k) * wp + pl % k)
                    stage[(pl * pitch + torch.arange(na)).reshape(-1)] = (
                        src[at.reshape(-1)])
                    nrun, length = _runs(k, a, na, pitch, nr)
                    _store_runs(out, o + r0 * k * a + a0, stage, 0, nrun,
                               length, a, pitch)
    assert not bool(out[out_pad:].isnan().any())
    return out[out_pad:].reshape(p_, *sim_y.shape, k * k, a)


def emulate_accumulate(vals, wv, kaiser, bidx, sim_y, sim_x, mask, ref, num,
                       den, k, nd, plan, doff=None, vals_pad=0):
    """accumulate_kernel's order of work (den None: the num-only form); the
    group tensor starts vals_pad floats into its buffer (its runs'
    alignment)."""
    p_, a, hp, wp = num.shape
    s_ = sim_y.numel()
    rows, tile, pitch, _ = plan
    kka = k * k * a
    src = torch.cat([torch.zeros(vals_pad, dtype=vals.dtype),
                     vals.reshape(-1)])
    accs = [torch.zeros(num.numel(), dtype=num.dtype)]
    if den is not None:
        accs.append(torch.zeros_like(accs[0]))
    sy, sx = sim_y.reshape(-1), sim_x.reshape(-1)
    flat_doff = None if doff is None else doff.reshape(s_, a)
    plane = a * hp * wp
    for s in range(s_):
        if not bool(mask.reshape(-1)[s]):
            continue
        for p in range(p_):
            v0 = vals_pad + (p * s_ + s) * kka
            kai = None if den is None else wv.reshape(p_, s_)[p, s] * kaiser
            for a0 in range(0, a, tile):
                na = min(tile, a - a0)
                base = _base_table(bidx, sy, sx, ref, s, a0, na, hp, wp, nd,
                                   flat_doff)
                for r0 in range(0, k, rows):
                    nr = min(rows, k - r0)
                    stage = torch.full((rows * k * pitch,), float("nan"),
                                       dtype=vals.dtype)
                    nrun, length = _runs(k, a, na, pitch, nr)
                    # a load: the windows follow the group tensor's side
                    for r in range(nrun):
                        g0 = v0 + r0 * k * a + a0 + r * a
                        off, valid, whole = windows(g0, length)
                        assert bool(((g0 + off[whole, 0]) % 4 == 0).all())
                        i = off[valid]
                        stage[r * pitch + i] = src[g0 + i]
                    # consecutive threads on consecutive pixels of one SAI,
                    # one scalar reduction each (num, and den)
                    al, px = (t.reshape(-1) for t in torch.meshgrid(
                        torch.arange(na), torch.arange(nr * k),
                        indexing="ij"))
                    at = p * plane + base[al] + (r0 + px // k) * wp + px % k
                    row = stage[px * pitch + al]
                    assert not bool(row.isnan().any())
                    accs[0].index_add_(0, at, row)
                    if kai is not None:
                        accs[1].index_add_(0, at, kai[r0 * k + px])
    num += accs[0].reshape(num.shape)
    if den is not None:
        den += accs[1].reshape(den.shape)


def _case(k, nd, a, dtype, seed, doff=False, n_g=2, n_n=3, p=2):
    """Planes [p, a, hp, wp] and slots of n_g groups x n_n similar patches
    with random displacements, a third of them masked."""
    rng = np.random.default_rng(seed)
    nsel = 2 * nd + 1
    hp, wp = k + 2 * nd + 6, k + 2 * nd + 9  # wp odd: rows change alignment
    planes = torch.as_tensor(rng.standard_normal((p, a, hp, wp)) * 40.0,
                             dtype=dtype)
    v0, v1 = hp - k + 1, wp - k + 1
    bidx = torch.as_tensor(rng.integers(0, nsel * nsel, (a, v0, v1)),
                           dtype=torch.int32)
    sim_y = torch.as_tensor(rng.integers(nd, v0 - nd, (n_g, n_n)),
                            dtype=torch.int32)
    sim_x = torch.as_tensor(rng.integers(nd, v1 - nd, (n_g, n_n)),
                            dtype=torch.int32)
    mask = torch.as_tensor(rng.random((n_g, n_n)) > 0.33)
    table = (torch.as_tensor(rng.integers(0, nsel * nsel, (n_g, n_n, a)),
                             dtype=torch.int32) if doff else None)
    return planes, bidx, sim_y, sim_x, mask, table


# (k, nd, A): k in {1, 3, 4, 8, 16}, odd and even A and A = 1, nd 0 to 2
SHAPES = [(1, 0, 5), (3, 1, 7), (4, 2, 9), (8, 1, 13), (8, 0, 6), (4, 1, 1),
          (16, 2, 3), (16, 1, 7)]
# forced plans (rows per chunk, SAIs per tile): chunks of whole rows that do
# not divide k, and SAI tiles, at the small shapes the CPU can emulate
FORCED = [(1, 3), (3, 4), (2, 5)]


def _plans(k, a):
    real = twokernel_plan(k, a)
    out = [real]
    for rows, tile in FORCED:
        rows, tile = min(rows, k), min(tile, a)
        out.append((rows, tile, tile | 1, 0))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("doff", [False, True])
@pytest.mark.parametrize("k,nd,a", SHAPES)
def test_extract_tiling_is_the_plain_gather(k, nd, a, doff, dtype):
    planes, bidx, sy, sx, mask, table = _case(k, nd, a, dtype, 7 * k + a,
                                              doff)
    ref = a // 2
    want = extract_groups_plain(planes, bidx, sy, sx, mask, ref, k=k, nd=nd,
                                doff=table)
    for i, plan in enumerate(_plans(k, a)):
        got = emulate_extract(planes, bidx, sy, sx, mask, ref, k, nd, plan,
                              doff=table, out_pad=i % 4)
        assert torch.equal(got, want), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("doff", [False, True])
@pytest.mark.parametrize("k,nd,a", SHAPES)
def test_accumulate_tiling_adds_what_the_plain_scatter_adds(k, nd, a, doff,
                                                            dtype):
    planes, bidx, sy, sx, mask, table = _case(k, nd, a, dtype, 5 * k + a,
                                              doff)
    ref = 0
    rng = np.random.default_rng(k * a)
    p_, n_g, n_n = planes.shape[0], *sy.shape
    wv = torch.as_tensor(rng.random((p_, n_g, n_n)), dtype=dtype) * mask
    kaiser = torch.as_tensor(rng.random(k * k), dtype=dtype)
    vals = (torch.as_tensor(rng.standard_normal((p_, n_g, n_n, k * k, a)),
                            dtype=dtype) * mask[None, :, :, None, None])
    num_p, den_p, one_p = (torch.zeros_like(planes) for _ in range(3))
    accumulate_groups_fused_plain(vals, wv, kaiser, bidx, sy, sx, mask, ref,
                                  num_p, den_p, k=k, nd=nd, doff=table)
    accumulate_groups_plain(vals, bidx, sy, sx, mask, ref, one_p, k=k, nd=nd,
                            doff=table)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i, plan in enumerate(_plans(k, a)):
        num, den, one = (torch.zeros_like(planes) for _ in range(3))
        emulate_accumulate(vals, wv, kaiser, bidx, sy, sx, mask, ref, num,
                           den, k, nd, plan, doff=table, vals_pad=i % 4)
        emulate_accumulate(vals, None, None, bidx, sy, sx, mask, ref, one,
                           None, k, nd, plan, doff=table, vals_pad=(i + 2) % 4)
        for got, want in ((num, num_p), (den, den_p), (one, one_p)):
            assert float((got - want).norm()) <= tol * float(want.norm()), \
                plan


def test_all_masked_slots_write_zeros_and_add_nothing():
    planes, bidx, sy, sx, _, _ = _case(4, 1, 5, torch.float32, 3)
    mask = torch.zeros(sy.shape, dtype=torch.bool)
    plan = twokernel_plan(4, 5)
    got = emulate_extract(planes, bidx, sy, sx, mask, 0, 4, 1, plan,
                          out_pad=3)
    assert torch.equal(got, torch.zeros_like(got))
    num, den = torch.zeros_like(planes), torch.zeros_like(planes)
    vals = torch.ones((2, *sy.shape, 16, 5))
    emulate_accumulate(vals, torch.ones((2, *sy.shape)), torch.ones(16), bidx,
                       sy, sx, mask, 0, num, den, 4, 1, plan)
    assert not bool(num.any()) and not bool(den.any())


@pytest.mark.parametrize("k", [1, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("a", [1, 9, 81, 289, 400, 1089, 5000])
def test_plan_fits_and_tiles_only_when_needed(k, a):
    """The stage budget keeps TK_BLOCKS_PER_SM blocks on an SM; whole patch
    rows per chunk; the SAI axis is tiled only where one row of every SAI
    does not fit; the pitch is odd (32 consecutive pixels of one SAI, 32
    banks)."""
    from lfbm5d_torch.kernels.extract import TK_BLOCKS_PER_SM
    from lfbm5d_torch.kernels.fused import SMEM_PER_SM, SMEM_RESERVED

    rows, tile, pitch, smem = twokernel_plan(k, a)
    assert 1 <= rows <= k and 1 <= tile <= a and pitch % 2 == 1
    assert pitch in (tile, tile + 1)
    assert smem == 8 * tile + 4 * k * k + 4 * rows * k * pitch
    assert smem <= SMEM_PER_SM // TK_BLOCKS_PER_SM - SMEM_RESERVED
    if tile < a:
        assert rows == 1
    if rows < k:  # one more row would not fit
        assert (smem + 4 * k * pitch
                > SMEM_PER_SM // TK_BLOCKS_PER_SM - SMEM_RESERVED)
