"""What the bf16 group kernels' tiling (csrc/group_stage.cuh, BF16 chain)
relies on, on the CPU: (a) the launch plan (`group_plan(..., bf16=True)`,
the Python copy of make_plan / plan_smem) fits and equals the library's
formula, transcribed here, at every bf16 shape the routes take, and the f32
plan is the f32 slice's, unchanged; (b) the bf16 slice layout (`item_stride`): the scatter,
stack, ldmatrix-row and fetch index maps visit every (coefficient, slot,
SAI) once, item rows never overlap, padded columns are never read as data
and the ldmatrix / stmatrix rows fall on distinct banks; (c) the
tensor-core angular pass, emulated lane by lane (ldmatrix.x4, mma
m16n8k16 with f32 sums in the kernel's k-tile order, stmatrix.x4.trans, the
sink of lanes past the last item), equals the plain dense product."""

import numpy as np
import pytest
import torch

from lfbm5d_torch.kernels import fused as kf

torch.set_num_threads(2)

NS = (1, 2, 4, 8, 16)
GRIDS = ((1, 1), (3, 5), (8, 8), (9, 9), (11, 11))
KK = 64


def _bf16(x) -> np.ndarray:
    """x rounded to bfloat16 (nearest even), as float32."""
    t = torch.as_tensor(np.asarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _ulps(x, y) -> np.ndarray:
    """Distance in bf16 steps between bf16-valued float32 arrays."""
    def ordered(v):
        bits = (np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
                >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(ordered(x) - ordered(y))


def _library_plan(n, a_h, a_w, wiener, bf16):
    """csrc/group_stage.cuh::make_plan and plan_smem, transcribed."""
    a = a_h * a_w
    patches = lambda cs: (n * a + cs - 1) // cs  # noqa: E731
    for per_sm in (2, 1):
        limit = min(233472 // per_sm - 1024, 232448) - 256
        cs = 1
        while cs <= 16:
            if bf16:
                ist = 8 * (((a + 7) // 8) | 1)
                kp = (a + 15) // 16 * 16
                words = ((2 if wiener else 1) * (KK // cs) * n * ist // 2
                         + 2 * patches(cs) + kp * (kp + 8) + 4)
            else:
                ps = (n * a_h * (a_w | 1)) | 1
                words = (2 if wiener else 1) * (KK // cs) * ps + 2 * patches(cs)
            if 4 * words <= limit:
                return cs, 512 // per_sm, 4 * words
            cs *= 2
    return None


def _f32_slice_plan(n, a_h, a_w, wiener):
    """The f32 chain's plan: its slice [regions][64/cs][(N*aH*(aW|1))|1]
    floats and the patch origins, the fewest CTAs that fit."""
    ps = (n * a_h * (a_w | 1)) | 1
    for per_sm in (2, 1):
        limit = min(232_448, 233_472 // per_sm - 1024)
        cs = 1
        while cs <= 16:
            patches = -(-n * a_h * a_w // cs)
            smem = 4 * ((2 if wiener else 1) * (64 // cs) * ps + 2 * patches)
            if smem <= limit - 256:
                return cs, 512 // per_sm, smem
            cs *= 2
    raise AssertionError("no plan")


@pytest.mark.parametrize("wiener", [False, True], ids=["ht", "wiener"])
@pytest.mark.parametrize("n_sim", NS)
def test_bf16_plan_fits_and_equals_library(n_sim, wiener):
    """At every bf16 shape of the routes the Python plan equals the
    library's formula and holds the bf16 slice, the origins, the
    16-byte-aligned tables and the static arrays in the CTAs per SM it
    assumes; the f32 plan is the f32 slice's, byte for byte."""
    for a_h, a_w in GRIDS:
        a = a_h * a_w
        plan = kf.group_plan(n_sim, a_h, a_w, wiener, bf16=True)
        assert plan == _library_plan(n_sim, a_h, a_w, wiener, True)
        cs, threads, smem = plan
        per_sm = kf.MAX_THREADS // threads
        assert per_sm * (smem + kf.STATIC_SMEM + kf.SMEM_RESERVED) \
            <= kf.SMEM_PER_SM
        ist = kf.item_stride(a)
        slice_b = (2 if wiener else 1) * (KK // cs) * n_sim * ist * 2
        origins_b = 8 * -(-n_sim * a // cs)
        kp = -(-a // 16) * 16
        tables_b = 2 * kp * (kp + 8) * 2
        tab0 = -(-(slice_b + origins_b) // 16) * 16
        assert slice_b % 16 == 0 and tab0 + tables_b <= smem
        f32 = kf.group_plan(n_sim, a_h, a_w, wiener)
        assert f32 == _f32_slice_plan(n_sim, a_h, a_w, wiener)
        assert f32 == _library_plan(n_sim, a_h, a_w, wiener, False)


def test_item_stride_and_table_words():
    """Rows of A rounded to 8 values and an odd number of 16-byte units;
    tables of 2 * KP rows of KP + 8 bf16."""
    for a in range(1, 129):
        ist = kf.item_stride(a)
        assert ist >= a and ist % 8 == 0 and (ist // 8) % 2 == 1
        assert ist - -(-a // 8) * 8 in (0, 8)
        kp = -(-a // 16) * 16
        assert kf.table_words(a) == kp * (kp + 8) + 4
    assert kf.item_stride(81) == 88 and kf.item_stride(64) == 72


# ---- the slice layout and the angular pass, lane by lane ------------------


def _item_off(it, lg_ns, n_sim, ist):
    return ((it >> lg_ns) * n_sim + (it & ((1 << lg_ns) - 1))) * ist


class Slice:
    """One CTA's bf16 slice as the kernel addresses it (element offsets),
    with a sink for stmatrix rows of lanes past the last item; counts every
    element read by ldmatrix and written by stmatrix."""

    def __init__(self, size):
        self.mem = np.zeros(size, dtype=np.float32)
        self.sink = np.zeros(8, dtype=np.float32)
        self.reads = []  # (matrix row start, lane rows) of B loads

    def ldmatrix_x4(self, addrs):
        """r[i][lane] = matrix i's (row lane // 4, columns 2 (lane % 4),
        +1); lane l gives row l % 8 of matrix l // 8."""
        r = np.empty((4, 32, 2), dtype=np.float32)
        for i in range(4):
            rows = [addrs[8 * i + j] for j in range(8)]
            self.reads.append(rows)
            for lane in range(32):
                base = rows[lane // 4] + 2 * (lane % 4)
                r[i, lane] = self.mem[base:base + 2]
        return r

    def stmatrix_x4_trans(self, addrs, regs):
        """Matrix i's element (row lane // 4, column 2 (lane % 4) + e) to
        position lane // 4 of the row lane 8i + 2 (lane % 4) + e gives."""
        for i in range(4):
            for lane in range(32):
                for e in range(2):
                    dst = addrs[8 * i + 2 * (lane % 4) + e]
                    if dst is None:
                        self.sink[lane // 4] = regs[i][lane, e]
                    else:
                        self.mem[dst + lane // 4] = regs[i][lane, e]


def _table_ldmatrix(tab, ks, addrs):
    r = np.empty((4, 32, 2), dtype=np.float32)
    for i in range(4):
        for lane in range(32):
            base = addrs[8 * i + lane // 4] + 2 * (lane % 4)
            r[i, lane] = tab[base:base + 2]
    return r


def _mma(d, a, b0, b1):
    """D (16x8, lane fragments) += A (16x16) B (16x8) in float32."""
    am = np.zeros((16, 16), dtype=np.float32)
    bm = np.zeros((16, 8), dtype=np.float32)
    dm = np.zeros((16, 8), dtype=np.float32)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for e in range(2):
            am[g, 2 * c + e] = a[0][lane, e]
            am[g + 8, 2 * c + e] = a[1][lane, e]
            am[g, 2 * c + 8 + e] = a[2][lane, e]
            am[g + 8, 2 * c + 8 + e] = a[3][lane, e]
            bm[2 * c + e, g] = b0[lane, e]
            bm[2 * c + 8 + e, g] = b1[lane, e]
            dm[g, 2 * c + e] = d[lane, e]
            dm[g + 8, 2 * c + e] = d[lane, 2 + e]
    dm = (dm + am @ bm).astype(np.float32)
    out = np.empty_like(d)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        out[lane] = (dm[g, 2 * c], dm[g, 2 * c + 1], dm[g + 8, 2 * c],
                     dm[g + 8, 2 * c + 1])
    return out


def angular_mma_emulated(sl: Slice, rows, lg_ns, n_sim, ist, a, tab, warps):
    """csrc/group_stage.cuh::angular_mma, every warp and lane: the kernel's
    address arithmetic, fragments and k-tile order; tab: the shared table
    [KP][KP + 8] flattened."""
    tiles = -(-a // 16)
    nb = 4 if tiles < 8 else 2  # csrc/group_stage.cuh::item_tiles
    ks = 16 * tiles + 8
    items = rows << lg_ns
    a8 = -(-a // 8) * 8
    half = a8 < 16 * tiles
    for w in range(warps):
        for ib in range(8 * nb * w, items, 8 * nb * warps):
            off = [[None] * 32 for _ in range(nb // 2)]
            for lane in range(32):
                mi, r8 = lane >> 3, lane & 7
                for jp in range(nb // 2):
                    it = ib + 8 * (2 * jp + (mi >> 1)) + r8
                    off[jp][lane] = (_item_off(it, lg_ns, n_sim, ist)
                                     if it < items else -1)
            b = {}
            for jp in range(nb // 2):
                for k in range(tiles):
                    cut = k == tiles - 1 and half
                    addrs = [max(off[jp][lane], 0) + 16 * k
                             + (0 if cut else 8 * ((lane >> 3) & 1))
                             for lane in range(32)]
                    f = sl.ldmatrix_x4(addrs)
                    zero = np.zeros((32, 2), dtype=np.float32)
                    b[2 * jp, k] = (f[0], zero if cut else f[1])
                    b[2 * jp + 1, k] = (f[2], zero if cut else f[3])
            for m in range(tiles):
                d = [np.zeros((32, 4), dtype=np.float32) for _ in range(nb)]
                for k in range(tiles):
                    addrs = [(16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)) * ks
                             + 16 * k + 8 * (lane >> 4) for lane in range(32)]
                    af = _table_ldmatrix(tab, ks, addrs)
                    for j in range(nb):
                        d[j] = _mma(d[j], af, *b[j, k])
                for jp in range(nb // 2):
                    addrs = []
                    for lane in range(32):
                        q0 = 16 * m + 8 * ((lane >> 3) & 1)
                        o = off[jp][lane]
                        addrs.append(o + q0 if o >= 0 and q0 < a8 else None)
                    regs = [_bf16(d[2 * jp][:, 0:2]), _bf16(d[2 * jp][:, 2:4]),
                            _bf16(d[2 * jp + 1][:, 0:2]),
                            _bf16(d[2 * jp + 1][:, 2:4])]
                    sl.stmatrix_x4_trans(addrs, regs)


# (aH, aW, N, ns, cpc, regions): odd and even aW, every tile count class,
# ragged item blocks (items not a multiple of 32), live slots < N
CASES = ((1, 1, 2, 2, 4, 1), (2, 2, 4, 4, 4, 2), (1, 4, 8, 8, 4, 1),
         (3, 3, 4, 2, 8, 1), (8, 8, 8, 8, 4, 2), (9, 9, 8, 8, 8, 1),
         (9, 9, 16, 4, 4, 2), (11, 11, 16, 16, 4, 1), (8, 16, 4, 4, 4, 1),
         (16, 8, 2, 1, 8, 2))


@pytest.mark.parametrize("a_h,a_w,n_sim,ns,cpc,regions", CASES)
def test_slice_layout_maps(a_h, a_w, n_sim, ns, cpc, regions):
    """Scatter / fetch (coefficient lc, slot n, SAI a) -> region * cpc * rs
    + lc * rs + n * ist + a and the stack pass's (lc, a) + n * ist visit
    every element once, inside the item's row and left of the padding;
    item rows are disjoint and 16-byte aligned."""
    a = a_h * a_w
    ist = kf.item_stride(a)
    rs = n_sim * ist
    seen = np.zeros(regions * cpc * rs, dtype=np.int64)
    for g in range(regions):
        for lc in range(cpc):
            for n in range(ns):
                for s in range(a_h):
                    for t in range(a_w):
                        sai = s * a_w + t  # the SAI index a of the scatter
                        seen[g * cpc * rs + lc * rs + n * ist + sai] += 1
    live = seen.reshape(regions * cpc, n_sim, ist)
    assert (live[:, :ns, :a] == 1).all()
    assert live[:, :, a:].sum() == 0 and live[:, ns:].sum() == 0
    stack = np.zeros_like(seen)
    for lc in range(cpc):
        for sai in range(a):  # stack items (lc, a), slot stride ist
            for n in range(ns):
                stack[lc * rs + n * ist + sai] += 1
    assert (stack.reshape(regions * cpc, n_sim, ist)[:cpc, :ns, :a] == 1).all()
    offs = sorted(_item_off(it, ns.bit_length() - 1, n_sim, ist)
                  for it in range((regions * cpc) << (ns.bit_length() - 1)))
    assert all(o % 8 == 0 for o in offs)  # 16 bytes of bf16
    assert all(b - a_ >= ist for a_, b in zip(offs, offs[1:]))


@pytest.mark.parametrize("a_h,a_w,n_sim,ns,cpc,regions", CASES)
def test_angular_mma_emulation(a_h, a_w, n_sim, ns, cpc, regions):
    """The tensor-core pass, emulated lane by lane on bf16 values in the
    slice layout, equals the plain dense product K v per item rounded to
    bf16 within one ulp; padding columns stay
    zero, slots beyond ns and lanes past the last item write nothing
    outside the sink, and only zero table columns meet padded columns."""
    a = a_h * a_w
    lg_ns = ns.bit_length() - 1
    ist = kf.item_stride(a)
    tiles = -(-a // 16)
    kp = 16 * tiles
    rng = np.random.default_rng(a * 100 + n_sim)
    kmat = _bf16(rng.standard_normal((a, a)) / np.sqrt(a))
    tab = np.zeros((kp, kp + 8), dtype=np.float32)
    tab[:a, :a] = kmat
    rows = regions * cpc
    sl = Slice(rows * n_sim * ist)
    vals = _bf16(rng.standard_normal((rows, n_sim, a)) * 30.0)
    view = sl.mem.reshape(rows, n_sim, ist)
    view[:, :, :a] = vals
    before = view.copy()
    angular_mma_emulated(sl, rows, lg_ns, n_sim, ist, a, tab.reshape(-1),
                         warps=2)
    got = view[:, :ns, :a]
    want = np.einsum("qa,rna->rnq", kmat.astype(np.float64),
                     vals[:, :ns].astype(np.float64))
    np.testing.assert_array_equal(got, _bf16(got))  # stored as bf16
    assert _ulps(got, _bf16(want)).max() <= 1
    assert (view[:, :, a:] == 0).all()  # padding stays zero
    np.testing.assert_array_equal(view[:, ns:], before[:, ns:])
    # every B row read stays inside one item's row; past A only zero
    # table columns meet it
    for rows_ in sl.reads:
        for start in rows_:
            assert start % 8 == 0
            assert (start % ist) + 8 <= ist
    assert not tab[:, a:kp].any()


@pytest.mark.parametrize("a_h,a_w", [(1, 1), (2, 2), (1, 4), (3, 3), (8, 8),
                                     (9, 9), (11, 11), (8, 16), (16, 8)])
def test_fragment_tiled_product(a_h, a_w):
    """The fragment-tiled dense product in float32 on bf16-valued inputs,
    accumulated over the k tiles in the kernel's order, equals the plain
    dense product to 1e-6 relative and, after bf16 rounding, within one
    ulp, at A in {1, 4, 9, 64, 81, 121, 128} (odd and even aW)."""
    a = a_h * a_w
    tiles = -(-a // 16)
    kp = 16 * tiles
    rng = np.random.default_rng(a + a_w)
    kmat = np.zeros((kp, kp), dtype=np.float32)
    kmat[:a, :a] = _bf16(rng.standard_normal((a, a)) / np.sqrt(a))
    v = np.zeros((kp, 64), dtype=np.float32)
    v[:a] = _bf16(rng.standard_normal((a, 64)) * 30.0)
    d = np.zeros((kp, 64), dtype=np.float32)
    for k in range(tiles):  # m16n8k16 tiles: m and n independent, k in order
        d = (d + kmat[:, 16 * k:16 * k + 16] @ v[16 * k:16 * k + 16]
             ).astype(np.float32)
    want = kmat.astype(np.float64) @ v.astype(np.float64)
    assert np.linalg.norm(d - want) <= 1e-6 * np.linalg.norm(want)
    assert _ulps(_bf16(d[:a]), _bf16(want[:a])).max() <= 1
    assert not d[a:].any()


def test_ldmatrix_rows_on_distinct_banks():
    """The 8 rows of every ldmatrix / stmatrix of the slice (8 consecutive
    items of one coefficient, ns >= 8) and of the table (8 consecutive
    rows) start in 8 distinct 16-byte bank groups."""
    for a in (1, 4, 9, 64, 81, 100, 121, 128):
        ist = kf.item_stride(a)
        kp = -(-a // 16) * 16
        for base in range(0, 64):
            groups = {((base + j) * ist * 2 // 16) % 8 for j in range(8)}
            assert len(groups) == 8
            tgroups = {((base + j) * (kp + 8) * 2 // 16) % 8
                       for j in range(8)}
            assert len(tgroups) == 8
