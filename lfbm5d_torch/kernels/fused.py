"""Group-stage kernels (csrc/fused.cu, csrc/fused_banked.cu) and their plain
version.

`fused_group_step` replaces lfbm5d_tpu/kernels/fused.py::fused_group_step
(and, folded into its prologue, lfbm5d_tpu/kernels/gather.py::sample_doff):
for every reference patch t of one reference SAI it extracts the 5D group at
the similar-patch positions and their per-SAI disparity offsets, runs the
forward transform chain, HT or Wiener shrinkage, the inverse chain, and adds
the weighted estimate into the numerator. It takes the `fused` route's
shapes: groups whose shared-memory budget fits one block
(`group_smem_bytes` <= 232,448 bytes, sides <= 16).

`fused_group_step_banked` replaces lfbm5d_tpu/kernels/fused.py::
fused_group_step_banked: the same function for the larger groups of the
`banked` route (17x17 grids, N=16 at 9x9; A <= 384 and aH, aW <= 19). Both
kernels run the passes of csrc/group_stage.cuh: a group is spread over a
thread-block cluster by spatial frequency, held in the cluster's shared
memory, so no group or Wiener factor goes to device memory; `group_plan`
is the launch plan (cluster size, threads, shared bytes per CTA). Both share
the plain version below.

`fused_group_step_bf16` and `fused_group_step_banked_bf16` are the same
kernels instantiated with the bfloat16 transform chain (BF16 in
csrc/group_stage.cuh): the counterpart of the reference kernels with
cdt = bfloat16 (its `pallas_bf16` engine), for grids of at most 128 SAIs.
They take GroupTables built with chain=torch.bfloat16, whose tables are
bf16-rounded (transforms/apply.py): the spatial 1-D factors in the packed
tables, the dense angular kron in `dense`, which the kernels apply on the
tensor cores (bf16 products, f32 sums). The group is rounded to bf16
when loaded, and the spatial, angular and stack contractions of either
direction each round their result to bf16 (the first spatial pass keeps
its f32 intermediate); shrinkage, the weights, the Kaiser weighting and the
accumulators stay f32. The plain version rounds at the same points
(GroupTransforms.chain), so on CPU tensors the bf16 wrappers run it with
those tables. Kernel and plain version add in
different orders, so a value within f32 rounding of a bf16 rounding
boundary may round the other way, and an HT coefficient near the threshold
may flip with it: they agree by relative L2 on num/wden, not to f32
rounding (bounds in chip_smoke.py, phase (p)). Their slices are bf16
(every value they hold is bf16-exact; `item_stride`), and each CTA holds
both directions' dense angular tables in shared memory for the kernel's
life (`group_plan(..., bf16=True)`, `table_words`), which at 9x9 leaves
the cluster sizes those of the f32 chain.

Contract (kernel and plain version alike), on the kernel's planar layout:
  noisy, basic   [C, A, Hp, Wp]   padded LF planes (basic: Wiener only)
  bidx           [A, V0, V1]      disparity argmin maps of this reference
  doff           [T, N, A] int32  optional per-slot displacement indices
                                  (the step's `take`/`dma` modes); None:
                                  sampled from bidx (`direct`). The
                                  reference SAI's lane is the centre in both.
  sim_y, sim_x   [T, N]           similar-patch positions (padded coords)
  lvl [T], mask [T, N]            stack level and live slots (flat groups and
                                  slots beyond 2**lvl are masked)
  num  += est * w * kaiser        at every patch pixel
  wden += w                       at every patch ORIGIN: the denominator is
                                  deferred; den = Kaiser convolution of wden
                                  (pipeline/engine.py), which equals the
                                  reference's direct den.
The kernel adds with f32 atomics in no fixed order, so it agrees with the
plain version to f32 rounding (relative 1e-4 on the accumulators; an HT
coefficient within rounding of the threshold may flip, which moves one
group). `launches` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lfbm5d_torch.config import StepParams
from lfbm5d_torch.kernels._build import check, library, require, stream_of
from lfbm5d_torch.kernels.gather import slot_doff
from lfbm5d_torch.ops.distances import center_index, displacements
from lfbm5d_torch.ops.shrinkage import filter_groups
from lfbm5d_torch.transforms import matrices as tm
from lfbm5d_torch.transforms.apply import GroupTransforms

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_N = 16  # stack depth the group kernels take
MAX_SIDE = 16  # angular grid side of the fused route's kernel
MAX_SIDE_BANKED = 19  # angular grid side of the banked kernel
MAX_A_BANKED = 384  # SAIs of the banked kernel (3 TPU banks of 128)
SMEM_PER_SM = 233_472  # bytes of shared memory of one SM
SMEM_RESERVED = 1024  # bytes the system keeps per resident block
STATIC_SMEM = 256  # bound on the group kernels' static shared memory
MAX_THREADS = 512  # threads per SM of the group kernels (16 warps)
MAX_CLUSTER = 16  # largest (non-portable) thread-block cluster on Hopper
# kernel_tables: f2 i2 kaiser (64 each), f4s i4s f4t i4t (19*19 slots),
# stack_f stack_i (levels 1, 2, 4, 8, 16 packed: 341 floats each)
_ANG_SLOT = 19 * 19
_STACK_SLOT = sum(4**lv for lv in range(5))
KERNEL_TABLE_FLOATS = 3 * 64 + 4 * _ANG_SLOT + 2 * _STACK_SLOT
DENSE_MAX_A = 128  # csrc/group_stage.cuh::KT: the bf16 chain's largest A
_CHUNK = 256  # groups per gather in the plain version (memory bound only)


def group_smem_bytes(n_sim: int, a: int, a_h: int, a_w: int) -> int:
    """The fused route's budget in bytes: a copy of
    csrc/fused.cu::lfbm5d_group_smem_bytes (the group [k^2][(N*A)|1], the
    tables and the patch origins in one block's shared memory), so routes
    are decided without the library. The kernels' own shared memory is
    `group_plan`'s."""
    levels = n_sim.bit_length()  # stack sizes 1, 2, ..., N
    tables = 3 * 64 + 2 * (a_h * a_h + a_w * a_w) + 2 * levels * n_sim**2
    return 4 * (64 * ((n_sim * a) | 1) + tables + 2 * n_sim * a)


def group_fits(sp: StepParams, a_h: int, a_w: int) -> bool:
    """True if the step's shapes take the `fused` route's group kernel."""
    return (sp.k == 8 and not sp.use_sd and sp.n_sim <= MAX_N
            and a_h <= MAX_SIDE and a_w <= MAX_SIDE
            and group_smem_bytes(sp.n_sim, a_h * a_w, a_h, a_w) <= MAX_SMEM)


def banked_fits(sp: StepParams, a_h: int, a_w: int) -> bool:
    """True if the banked group kernel takes this step's shapes."""
    return (sp.k == 8 and not sp.use_sd and sp.n_sim <= MAX_N
            and a_h <= MAX_SIDE_BANKED and a_w <= MAX_SIDE_BANKED
            and a_h * a_w <= MAX_A_BANKED)


def item_stride(a: int) -> int:
    """bf16 values per item row of the bf16 chain's slice (a copy of
    csrc/group_stage.cuh::item_stride): A rounded up to 8 and then to an odd
    number of 16-byte units, so rows start on 16 bytes and the 8 rows of one
    ldmatrix or stmatrix fall on distinct banks."""
    return 8 * (-(-a // 8) | 1)


def table_words(a: int) -> int:
    """Words of the bf16 chain's shared angular tables (a copy of
    csrc/group_stage.cuh::table_words): both directions' dense tables,
    resident for the kernel's life, 2*KP rows of KP + 8 bf16 (KP = A
    rounded up to 16: an odd number of 16-byte units a row), and 4 words
    to align them to 16 bytes."""
    kp = -(-a // 16) * 16
    return kp * (kp + 8) + 4


def group_plan(n_sim: int, a_h: int, a_w: int, wiener: bool,
               bf16: bool = False) -> tuple[int, int, int]:
    """(cluster size, threads, dynamic shared bytes per CTA) of the group
    kernels: a copy of csrc/group_stage.cuh::make_plan. Each CTA holds 64/cs
    spatial frequencies of the group (two regions for Wiener) and the
    origins of its share of the N*A patches: the f32 chain as
    [regions][64/cs][ps] floats, ps = (N*aH*(aW|1))|1; the bf16 chain as
    [regions][64/cs][N][item_stride(A)] bf16 and both angular tables
    (`table_words`). The fewest CTAs that fit two 256-thread CTAs on an SM,
    else one 512-thread CTA. Raises if no cluster holds the group."""
    a = a_h * a_w
    regions = 2 if wiener else 1
    for per_sm in (2, 1):
        limit = min(MAX_SMEM, SMEM_PER_SM // per_sm - SMEM_RESERVED)
        cs = 1
        while cs <= MAX_CLUSTER:
            patches = -(-n_sim * a // cs)
            if bf16:
                words = (regions * (64 // cs) * n_sim * item_stride(a) // 2
                         + 2 * patches + table_words(a))
            else:
                ps = (n_sim * a_h * (a_w | 1)) | 1
                words = regions * (64 // cs) * ps + 2 * patches
            if 4 * words <= limit - STATIC_SMEM:
                return cs, MAX_THREADS // per_sm, 4 * words
            cs *= 2
    raise ValueError(f"no cluster of <= {MAX_CLUSTER} CTAs holds an N={n_sim}"
                     f" {a_h}x{a_w} group")


def kernel_tables(parts, stack_f, stack_i, device) -> torch.Tensor:
    """The group kernels' constant-memory tables (csrc/group_stage.cuh::
    Tables), f32: parts = (f2, i2, kaiser, f4s, i4s, f4t, i4t), the angular
    ones each at the head of a 19*19 slot; then the stack matrices
    [levels, N, N] of sizes s = 1, 2, ..., N as [s][s] at (s*s - 1)/3 of
    their slot."""
    out = torch.zeros(KERNEL_TABLE_FLOATS, dtype=torch.float32, device=device)
    offs = (0, 64, 128) + tuple(192 + i * _ANG_SLOT for i in range(4))
    for off, m in zip(offs, parts):
        out[off:off + m.numel()] = m.reshape(-1)
    base = 192 + 4 * _ANG_SLOT
    for i, st in enumerate((stack_f, stack_i)):
        for lv in range(st.shape[0]):
            s = 1 << lv
            off = base + i * _STACK_SLOT + (s * s - 1) // 3
            out[off:off + s * s] = st[lv, :s, :s].reshape(-1)
    return out


def dense_tables(f4: torch.Tensor, i4: torch.Tensor) -> torch.Tensor:
    """The bf16 chain's dense angular tables as the kernels read them
    (csrc/group_stage.cuh::angular_dense, the A operand of its tensor-core
    products): [2, KP, KP] bfloat16, forward then inverse, row-major (q, a),
    zero padded to KP = A rounded up to 16 (the tables hold bf16 values, so
    the cast is exact)."""
    a = f4.shape[0]
    kp = -(-a // 16) * 16
    out = torch.zeros((2, kp, kp), dtype=torch.bfloat16, device=f4.device)
    out[0, :a, :a] = f4
    out[1, :a, :a] = i4
    return out


@dataclass(frozen=True)
class GroupTables:
    """Transform constants of one step: the plain version's GroupTransforms
    and Kaiser window, and the same tables laid out for the kernels."""

    gt: GroupTransforms  # gt.chain: the transform chain's dtype (or None)
    kaiser: torch.Tensor  # [k, k]
    packed: torch.Tensor | None  # f32 `kernel_tables`; None: no kernel fits
    a_h: int
    a_w: int
    dense: torch.Tensor | None = None  # bf16 chain: `dense_tables`

    @staticmethod
    def build(sp: StepParams, a_h: int, a_w: int, dtype=torch.float32,
              device="cpu", chain: torch.dtype | None = None
              ) -> "GroupTables":
        gt = GroupTransforms.build(sp, a_h, a_w, dtype=dtype, device=device,
                                   chain=chain)
        kai = torch.as_tensor(tm.kaiser_window(sp.k), dtype=dtype,
                              device=device)

        def ang(m, size):
            if m is None:
                return torch.eye(size, dtype=dtype, device=device)
            return m

        parts = (gt.f2, gt.i2, kai, ang(gt.f4s, a_h), ang(gt.i4s, a_h),
                 ang(gt.f4t, a_w), ang(gt.i4t, a_w))
        fits = max(a_h, a_w) <= MAX_SIDE_BANKED and sp.n_sim <= MAX_N
        packed = (kernel_tables(parts, gt.stack_f, gt.stack_i, device)
                  if fits else None)
        dense = (dense_tables(gt.f4, gt.i4)
                 if gt.f4 is not None and a_h * a_w <= DENSE_MAX_A
                 else None)
        return GroupTables(gt, kai, packed, a_h, a_w, dense)


def fused_group_step_plain(noisy, basic, bidx, sim_y, sim_x, lvl, mask,
                           ref: int, sigma_c, tables: GroupTables, num, wden,
                           *, k: int, nd: int, lambda_3d: float,
                           wiener: bool, use_sd: bool = False,
                           doff=None) -> None:
    """Plain torch version of the group kernel (same contract, in place)."""
    c, a, _, _ = noisy.shape
    t, n_sim = sim_y.shape
    gt, a_h, a_w = tables.gt, tables.a_h, tables.a_w
    dev = noisy.device
    disp_ang = torch.as_tensor(displacements(nd), dtype=torch.long, device=dev)
    ang = slot_doff(bidx, sim_y, sim_x, ref, center_index(nd), doff)
    ku = torch.arange(k, device=dev)[:, None]
    kv = torch.arange(k, device=dev)[None, :]
    a_b = torch.arange(a, device=dev)[None, None, :, None, None]
    a_o = a_b[..., 0, 0]  # [1, 1, A]
    # channel-last views of the planar tensors: same gathers as the dense step
    nv = noisy.permute(1, 2, 3, 0)
    bv = basic.permute(1, 2, 3, 0) if wiener else None
    numv = num.permute(1, 2, 3, 0)
    wdv = wden.permute(1, 2, 3, 0)
    for s0 in range(0, t, _CHUNK):
        s1 = min(t, s0 + _CHUNK)
        tc = s1 - s0
        clvl = lvl[s0:s1].long()
        aoff = disp_ang[ang[s0:s1].long()]  # [Tc, N, A, 2]
        ay = sim_y[s0:s1, :, None].long() + aoff[..., 0]
        ax = sim_x[s0:s1, :, None].long() + aoff[..., 1]
        yy = ay[..., None, None] + ku
        xx = ax[..., None, None] + kv
        shape = (tc, n_sim, a_h, a_w, k, k, c)
        g = nv[a_b, yy, xx].reshape(shape)
        gb = bv[a_b, yy, xx].reshape(shape) if wiener else None
        est, wgt = filter_groups(g, gb, clvl, gt, sigma_c, lambda_3d, use_sd)
        est = est.reshape(tc, n_sim, a, k, k, c)
        wm = wgt[:, None, :] * mask[s0:s1, :, None]  # [Tc, N, C]
        wfull = wm[:, :, None, None, None, :] * tables.kaiser[..., None]
        numv.index_put_((a_b, yy, xx), est * wfull, accumulate=True)
        wdv.index_put_((a_o, ay, ax),
                       wm[:, :, None, :].expand(tc, n_sim, a, c),
                       accumulate=True)


def _check(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask, sigma_c,
           tables, num, wden, k, wiener, use_sd, what):
    """Raise unless the kernels take these tensors; (c, a, hp, wp, t, n)."""
    dev = noisy.device
    f32 = torch.float32
    require(noisy, "noisy", f32, 4)
    c, a, hp, wp = noisy.shape
    if wiener:
        require(basic, "basic", f32, 4, dev)
        if basic.shape != noisy.shape:
            raise ValueError("basic and noisy differ in shape")
    require(bidx, "bidx", torch.int32, 3, dev)
    require(sim_y, "sim_y", torch.int32, 2, dev)
    require(sim_x, "sim_x", torch.int32, 2, dev)
    require(lvl, "lvl", torch.int32, 1, dev)
    require(mask, "mask", torch.bool, 2, dev)
    require(sigma_c, "sigma_c", f32, 1, dev)
    require(num, "num", f32, 4, dev)
    require(wden, "wden", f32, 4, dev)
    if tables.packed is None:
        raise ValueError(f"{what}: no group kernel takes {tables.a_h}x"
                         f"{tables.a_w} SAIs at these tables' N")
    require(tables.packed, "tables.packed", f32, 1, dev)
    t, n_sim = sim_y.shape
    if k != 8:
        raise ValueError(f"{what}: built for k=8, got k={k}")
    if use_sd:
        raise ValueError(f"{what}: does not take use_sd weights")
    if (bidx.shape != (a, hp - k + 1, wp - k + 1)
            or sim_x.shape != (t, n_sim) or lvl.shape != (t,)
            or mask.shape != (t, n_sim) or sigma_c.shape != (c,)
            or num.shape != noisy.shape or wden.shape != noisy.shape
            or tables.a_h * tables.a_w != a):
        raise ValueError(f"{what}: inconsistent shapes")
    if doff is not None:
        require(doff, "doff", torch.int32, 3, dev)
        if doff.shape != (t, n_sim, a):
            raise ValueError(f"{what}: doff {tuple(doff.shape)} vs "
                             f"{(t, n_sim, a)}")
    return c, a, hp, wp, t, n_sim


def _pointers(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask, sigma_c,
              tables, num, wden, wiener):
    """The pointer arguments of both C entry points, in order."""
    return (noisy.data_ptr(), basic.data_ptr() if wiener else None,
            bidx.data_ptr(), None if doff is None else doff.data_ptr(),
            sim_y.data_ptr(), sim_x.data_ptr(), lvl.data_ptr(),
            mask.data_ptr(), sigma_c.data_ptr(), tables.packed.data_ptr(),
            None if tables.dense is None else tables.dense.data_ptr(),
            num.data_ptr(), wden.data_ptr())


def _launch_what(name, n_sim, a_h, a_w, wiener, bf16):
    """`name` and the shape and plan it launched, for a launch error."""
    cs, threads, smem = group_plan(n_sim, a_h, a_w, wiener, bf16)
    return (f"{name} (N={n_sim}, {a_h}x{a_w} SAIs, "
            f"{'Wiener' if wiener else 'HT'}: clusters of {cs} CTAs x "
            f"{threads} threads, {smem} bytes of shared memory each)")


def _group_step(fn, banked: bool, bf16: bool, noisy, basic, bidx, sim_y,
                sim_x, lvl, mask, ref, sigma_c, tables, num, wden, k, nd,
                lambda_3d, wiener, use_sd, doff) -> None:
    """The four wrappers below: the plain version on CPU tensors, else the
    fused or banked kernel in the f32 or bf16 chain; fn counts the
    launches."""
    chain = torch.bfloat16 if bf16 else None
    if tables.gt.chain != chain:
        raise ValueError(f"{fn.__name__} takes tables built with chain="
                         f"{chain}, got {tables.gt.chain}")
    if noisy.device.type == "cpu":
        return fused_group_step_plain(
            noisy, basic, bidx, sim_y, sim_x, lvl, mask, ref, sigma_c, tables,
            num, wden, k=k, nd=nd, lambda_3d=lambda_3d, wiener=wiener,
            use_sd=use_sd, doff=doff,
        )
    what = "banked group kernel" if banked else "group kernel"
    c, a, hp, wp, t, n_sim = _check(
        noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask, sigma_c, tables,
        num, wden, k, wiener, use_sd, what)
    a_h, a_w = tables.a_h, tables.a_w
    if bf16:
        if a > DENSE_MAX_A:
            raise ValueError(f"{fn.__name__}: the bf16 chain takes A <= "
                             f"{DENSE_MAX_A}, got {a_h}x{a_w}")
        if tables.dense is not None:
            require(tables.dense, "tables.dense", torch.bfloat16, 3,
                    noisy.device)
    if banked:
        if (n_sim > MAX_N or a_h > MAX_SIDE_BANKED or a_w > MAX_SIDE_BANKED
                or a > MAX_A_BANKED):
            raise ValueError(
                f"{what} takes N <= {MAX_N}, aH, aW <= {MAX_SIDE_BANKED}, "
                f"A <= {MAX_A_BANKED}; got N={n_sim}, {a_h}x{a_w}")
    else:
        if n_sim > MAX_N or a_h > MAX_SIDE or a_w > MAX_SIDE:
            raise ValueError(f"{what} takes N, aH, aW <= 16; got N={n_sim}, "
                             f"{a_h}x{a_w}")
        smem = group_smem_bytes(n_sim, a, a_h, a_w)
        if smem > MAX_SMEM:
            raise ValueError(
                f"{what}: N={n_sim}, A={a} is over the fused route's "
                f"budget ({smem} > {MAX_SMEM} bytes); the banked kernel "
                f"takes it")
    if t == 0:
        return
    entry = "lfbm5d_group_step_banked" if banked else "lfbm5d_group_step"
    with torch.cuda.device(noisy.device):  # launch_groups' host calls too
        rc = getattr(library(), entry)(
            *_pointers(noisy, basic, bidx, doff, sim_y, sim_x, lvl, mask,
                       sigma_c, tables, num, wden, wiener),
            t, n_sim, a, a_h, a_w, c, hp, wp, hp - k + 1, wp - k + 1, nd,
            ref, int(wiener), int(bf16), float(lambda_3d), stream_of(noisy),
        )
    if rc:
        check(rc, _launch_what(fn.__name__, n_sim, a_h, a_w, wiener, bf16))
    fn.launches += 1


def fused_group_step(noisy, basic, bidx, sim_y, sim_x, lvl, mask, ref: int,
                     sigma_c, tables: GroupTables, num, wden, *, k: int,
                     nd: int, lambda_3d: float, wiener: bool,
                     use_sd: bool = False, doff=None) -> None:
    """One reference SAI's group stage, accumulated into num/wden in place
    (contract in the module docstring). CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    _group_step(fused_group_step, False, False, noisy, basic, bidx, sim_y,
                sim_x, lvl, mask, ref, sigma_c, tables, num, wden, k, nd,
                lambda_3d, wiener, use_sd, doff)


def fused_group_step_banked(noisy, basic, bidx, sim_y, sim_x, lvl, mask,
                            ref: int, sigma_c, tables: GroupTables, num, wden,
                            *, k: int, nd: int, lambda_3d: float,
                            wiener: bool, use_sd: bool = False,
                            doff=None) -> None:
    """`fused_group_step` for the `banked` route's larger groups (the same
    contract, plain version and cluster design; up to 19x19 SAIs)."""
    _group_step(fused_group_step_banked, True, False, noisy, basic, bidx,
                sim_y, sim_x, lvl, mask, ref, sigma_c, tables, num, wden, k,
                nd, lambda_3d, wiener, use_sd, doff)


def fused_group_step_bf16(noisy, basic, bidx, sim_y, sim_x, lvl, mask,
                          ref: int, sigma_c, tables: GroupTables, num, wden,
                          *, k: int, nd: int, lambda_3d: float, wiener: bool,
                          use_sd: bool = False, doff=None) -> None:
    """`fused_group_step` with the bfloat16 transform chain (tables built
    with chain=torch.bfloat16; module docstring)."""
    _group_step(fused_group_step_bf16, False, True, noisy, basic, bidx, sim_y,
                sim_x, lvl, mask, ref, sigma_c, tables, num, wden, k, nd,
                lambda_3d, wiener, use_sd, doff)


def fused_group_step_banked_bf16(noisy, basic, bidx, sim_y, sim_x, lvl, mask,
                                 ref: int, sigma_c, tables: GroupTables, num,
                                 wden, *, k: int, nd: int, lambda_3d: float,
                                 wiener: bool, use_sd: bool = False,
                                 doff=None) -> None:
    """`fused_group_step_banked` with the bfloat16 transform chain."""
    _group_step(fused_group_step_banked_bf16, True, True, noisy, basic, bidx,
                sim_y, sim_x, lvl, mask, ref, sigma_c, tables, num, wden, k,
                nd, lambda_3d, wiener, use_sd, doff)


fused_group_step.launches = 0
fused_group_step_banked.launches = 0
fused_group_step_bf16.launches = 0
fused_group_step_banked_bf16.launches = 0
