"""What the block-matching kernels (csrc/bm.cu) rely on, on the CPU: their
decomposition, emulated in float32 torch from the launch plan, equals the
plain versions (`lfbm5d_torch.ops.distances`) bit for bit.

Cross-argmin: output tiles of TILE_Y x (TILE_VC-k+1) with their SAI tiles
and halo zero-filled outside the plane, SAI chunks walked per block, the
reference held as column strips of STRIP_ROWS+k-1 values, vertical sums in a
[TILE_Y][sv_pitch] buffer whose pad columns are zero, horizontal sums over
row segments of SEG_COLS from NH loaded values, dx visited outer and dy inner
with ties broken on the displacement index. Self-BM: the window at an odd
pitch with room for the ragged last run, runs of SELF_R adjacent dx, window
columns added into every box of the run, and the threads' (dy, run) walk
without division.
"""

import numpy as np
import pytest
import torch

from lfbm5d_torch.kernels.bm import (
    CROSS_BLOCKS_PER_SM, NUM_SMS, SEG_COLS, SELF_R, STRIP_ROWS, TILE_VC,
    TILE_Y, bm_plan, self_plan, sv_pitch,
)
from lfbm5d_torch.ops.distances import (
    _quantize, cross_argmin_all, self_distances,
)

torch.set_num_threads(2)

INT_MAX = np.iinfo(np.int32).max
HP, WP, A = 50, 75, 5  # neither side a tile multiple at k = 1, 4, 8, 16


def _cdiv(a, b):
    return -(-a // b)


def _planes(seed, levels=None):
    rng = np.random.default_rng(seed)
    if levels:  # few grey levels: many equal distances
        x = rng.integers(0, levels, (A, HP, WP)).astype(np.float32) * 40.0
    else:
        x = (rng.random((A, HP, WP)) * 255.0).astype(np.float32)
    return torch.as_tensor(x)


def emulate_cross(ref, planes, k, nd, chunk=None):
    """csrc/bm.cu::cross_argmin_kernel's algorithm, every tile at once."""
    a, hp, wp = planes.shape
    ty, tx, plan_chunk, grid, _ = bm_plan(hp, wp, a, k, nd)
    chunk = chunk or plan_chunk
    v0, v1 = hp - k + 1, wp - k + 1
    tiles_y, tiles_x = _cdiv(v0, ty), _cdiv(v1, tx)
    assert grid == tiles_y * tiles_x * _cdiv(a, plan_chunk)
    nsel, nr, pitch = 2 * nd + 1, STRIP_ROWS + k - 1, sv_pitch(k)
    sh, sw = ty + k - 1 + 2 * nd, TILE_VC + 2 * nd
    nh = 4 * _cdiv(SEG_COLS + k - 1, 4)
    strips = ty // STRIP_ROWS
    by = torch.arange(tiles_y) * ty
    bx = torch.arange(tiles_x) * tx

    def tiles_of(img, rows, cols, off):
        """[..., tiles_y, tiles_x, rows, cols] windows of img at the tile
        origins less off, zero outside img."""
        ext = torch.zeros(*img.shape[:-2], (tiles_y - 1) * ty + rows + off,
                          (tiles_x - 1) * tx + cols + off)
        ext[..., off:off + img.shape[-2], off:off + img.shape[-1]] = img
        ri = by[:, None] + torch.arange(rows)
        ci = bx[:, None] + torch.arange(cols)
        t = ext[..., ri[:, None, :, None], ci[None, :, None, :]]
        return t.reshape(*img.shape[:-2], tiles_y * tiles_x, rows, cols)

    sai = tiles_of(planes, sh, sw, nd)  # [A, tiles, sh, sw]
    reft = tiles_of(ref, ty + k - 1, TILE_VC, 0)  # [tiles, ty+k-1, VC]
    # a thread's reference strip: rows strip*STRIP_ROWS + [0, nr) of a column
    rr = torch.stack([reft[:, s * STRIP_ROWS:s * STRIP_ROWS + nr]
                      for s in range(strips)], 1)  # [tiles, strips, nr, VC]
    out = torch.zeros(a, v0, v1, dtype=torch.int32)
    for c0 in range(0, a, chunk):
        for s in range(c0, min(a, c0 + chunk)):
            best = torch.full((tiles_y * tiles_x, ty, TILE_VC), INT_MAX,
                              dtype=torch.int32)
            bidx = torch.zeros_like(best)
            for dxi in range(nsel):
                col = torch.stack([
                    sai[s, :, s_ * STRIP_ROWS:s_ * STRIP_ROWS + nr + 2 * nd,
                        dxi:dxi + TILE_VC] for s_ in range(strips)], 1)
                for dyi in range(nsel):
                    d = rr - col[:, :, dyi:dyi + nr]
                    e = d * d
                    v = e[:, :, 0:STRIP_ROWS]
                    for i in range(1, k):
                        v = v + e[:, :, i:i + STRIP_ROWS]
                    sv = torch.zeros(tiles_y * tiles_x, ty, pitch)
                    sv[..., :TILE_VC] = v.reshape(-1, ty, TILE_VC)
                    # each segment's NH loaded sums; pad columns are zero
                    h = torch.stack([sv[..., g * SEG_COLS:g * SEG_COLS + nh]
                                     for g in range(TILE_VC // SEG_COLS)], 2)
                    box = h[..., 0:SEG_COLS]
                    for j in range(1, k):
                        box = box + h[..., j:j + SEG_COLS]
                    q = _quantize(box, k).reshape(best.shape)
                    m = dyi * nsel + dxi
                    better = (q < best) | ((q == best) & (m < bidx))
                    best = torch.where(better, q, best)
                    bidx = torch.where(better, torch.full_like(bidx, m), bidx)
            grid_out = bidx.reshape(tiles_y, tiles_x, ty, TILE_VC)[..., :tx]
            full = grid_out.permute(0, 2, 1, 3).reshape(tiles_y * ty,
                                                        tiles_x * tx)
            out[s] = full[:v0, :v1]
    return out


def emulate_self(plane, ys, xs, k, n):
    """csrc/bm.cu::self_distances_kernel's algorithm, every patch at once."""
    hp, wp = plane.shape
    _, pitch, nruns = self_plan(k, n, len(ys) * len(xs))
    nsel, win = 2 * n + 1, k + 2 * n
    ext = torch.zeros(hp + 2 * n + win, wp + 2 * n + pitch)
    ext[n:n + hp, n:n + wp] = plane
    y0 = torch.as_tensor(np.repeat(ys, len(xs)), dtype=torch.long)
    x0 = torch.as_tensor(np.tile(xs, len(ys)), dtype=torch.long)
    wnd = ext[(y0[:, None] + torch.arange(win))[:, :, None],
              (x0[:, None] + torch.arange(pitch))[:, None, :]]
    ref = wnd[:, n:n + k, n:n + k]
    dy = torch.arange(nsel)[:, None]
    run = torch.arange(nruns)[None, :]
    box = [None] * SELF_R
    for c in range(k + SELF_R - 1):
        # window column c of every run: [T, dy, run, k]
        w = torch.stack([wnd[:, dy + i, run * SELF_R + c] for i in range(k)],
                        -1)
        for r in range(SELF_R):
            j = c - r
            if not 0 <= j < k:
                continue
            v = None
            for i in range(k):
                d = ref[:, i, j][:, None, None] - w[..., i]
                e = d * d
                v = e if i == 0 else v + e
            box[r] = v if j == 0 else box[r] + v
    q = _quantize(torch.stack(box, -1), k)  # [T, dy, run, SELF_R]
    return q.reshape(len(y0), nsel, nruns * SELF_R)[..., :nsel].reshape(
        len(y0), nsel * nsel)


@pytest.mark.parametrize("nd", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_cross_tiling_equals_plain(k, nd):
    planes = _planes(10 * k + nd)
    want = cross_argmin_all(planes[2], planes, k, nd)
    got = emulate_cross(planes[2], planes, k, nd, chunk=2)  # A % 2 != 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("k", [4, 8])
def test_cross_tiling_ties_first_occurrence(k, nd):
    """Planes of three grey levels: many displacements tie, and the
    dx-outer visit order must still return the row-major first one."""
    planes = _planes(k + nd, levels=3)
    want = cross_argmin_all(planes[0], planes, k, nd)
    assert int((want > 0).sum()) > 0
    got = emulate_cross(planes[0], planes, k, nd)
    assert torch.equal(got, want)
    flat = torch.zeros_like(planes)  # every displacement ties: index 0
    assert int(emulate_cross(flat[0], flat, k, nd).abs().sum()) == 0


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_self_tiling_equals_plain(k, n):
    """Reference grids that start at the plane's edge: the windows' zero
    fill; the last run of SELF_R dx is ragged for every n here."""
    plane = _planes(k * n)[1]
    ys = np.arange(0, HP - k + 1, 7)
    xs = np.arange(0, WP - k + 1, 9)
    want = self_distances(plane, ys, xs, k, n)
    assert torch.equal(emulate_self(plane, ys, xs, k, n), want)


@pytest.mark.parametrize("t", [256, 4345, 29601])  # 17x17, matched, default
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_self_threads_walk_every_item_once(n, t):
    """The kernel's (dy, run) walk: start at divmod(tid, nruns), then add
    divmod(threads, nruns) with one carry; every item once, and no round
    but the last runs less than full, the last more than a quarter full
    where a patch has a warp's worth of items."""
    threads, _, nruns = self_plan(8, n, t)
    items = (2 * n + 1) * nruns
    sdy, srun = divmod(threads, nruns)
    seen = []
    for tid in range(threads):
        dy, run = divmod(tid, nruns)
        for item in range(tid, items, threads):
            assert (dy, run) == divmod(item, nruns)
            seen.append(item)
            run, dy = run + srun, dy + sdy
            if run >= nruns:
                run, dy = run - nruns, dy + 1
    assert sorted(seen) == list(range(items))
    assert threads % 32 == 0 and threads <= 256
    last = items - (_cdiv(items, threads) - 1) * threads
    assert last > (threads // 4 if items >= 32 else 0)


@pytest.mark.parametrize("hp,wp,a,nd", [
    (468, 659, 81, 1),   # matched flagship
    (470, 661, 81, 2),   # `default` flagship
    (454, 645, 81, 2),   # `fast`
    (162, 162, 289, 1),  # 17x17x128x128
    (546, 546, 289, 1),  # 17x17x512x512
])
def test_plan_fills_two_waves(hp, wp, a, nd):
    ty, tx, chunk, grid, smem = bm_plan(hp, wp, a, 8, nd)
    tiles = _cdiv(hp - 7, ty) * _cdiv(wp - 7, tx)
    assert grid == tiles * _cdiv(a, chunk)
    assert grid >= 2 * NUM_SMS * CROSS_BLOCKS_PER_SM
    assert CROSS_BLOCKS_PER_SM * (smem + 1024) <= 233_472
    assert (ty, tx) == (TILE_Y, TILE_VC - 7)


@pytest.mark.parametrize("k", range(1, 17))
def test_sv_pitch_conflict_free(k):
    """The last segment's float4 loads fit the pitch, and the 8 lanes of a
    quarter-warp (rows r, r+1; segments 4g..4g+3) hit 8 distinct 16-byte
    bank groups in every load."""
    p = sv_pitch(k)
    nh = 4 * _cdiv(SEG_COLS + k - 1, 4)
    assert p % 4 == 0 and TILE_VC - SEG_COLS + nh <= p
    for q in range(nh // 4):
        for g in (0, 4):
            groups = {((r * p + s * SEG_COLS) // 4 + q) % 8
                      for r in (0, 1) for s in range(g, g + 4)}
            assert len(groups) == 8
