"""What the redesigned group kernels (csrc/group_stage.cuh) rely on, on the
CPU: (a) the launch plan (`group_plan`, the Python copy of the launcher's
make_plan) fits the card for every shape the `fused` and `banked` routes
take; (b) the decomposition -- a group spread over a cluster of cs CTAs by
spatial frequency, each CTA's slice in the kernel's layout, the shrink
weights summed over the CTAs' partials in rank order -- reproduces
`fused_group_step_plain` in float64."""

import pytest
import torch

from lfbm5d_torch.config import StepParams
from lfbm5d_torch.kernels.fused import (
    MAX_CLUSTER, MAX_SMEM, MAX_THREADS, SMEM_PER_SM, SMEM_RESERVED,
    STATIC_SMEM, fused_group_step_plain, group_plan,
)
from lfbm5d_torch.lf import add_noise_np, synthetic_lf_multi
from lfbm5d_torch.pipeline import denoise as tden
from lfbm5d_torch.pipeline.engine import build_kernel_step, resolve_route

torch.set_num_threads(2)

K = 8
H, W, C = 24, 32, 2
SIGMA = 25.0
LAMBDA = 2.7
GRIDS = ((3, 3), (5, 5), (3, 5))  # (aH, aW); 3x5 tells the two axes apart


def _sp(n_sim: int) -> StepParams:
    return StepParams(tau_match=2500.0, n_sim=n_sim, n_search=4, n_disp=1,
                      k=K, p=3, flat_tau=1.3)


def _layout(n_sim, a_h, a_w, cs):
    """(awp, ap, ps, cpc) of a CTA's slice: column n*ap + s*awp + t."""
    awp = a_w | 1
    ap = a_h * awp
    return awp, ap, (n_sim * ap) | 1, 64 // cs


@pytest.mark.parametrize("wiener", [False, True], ids=["ht", "wiener"])
@pytest.mark.parametrize("n_sim", [1, 2, 4, 8, 16])
def test_launch_plan_fits(n_sim, wiener):
    """Every shape routed to a group kernel (sides 1..19) has a plan of at
    most 16 CTAs whose slice, origins and static arrays fit the CTAs per SM
    it assumes, and whose shared bytes hold the slice layout."""
    routed = 0
    for a_h in range(1, 20):
        for a_w in range(1, 20):
            if resolve_route(_sp(n_sim), a_h, a_w) == "two_kernel":
                continue
            routed += 1
            cs, threads, smem = group_plan(n_sim, a_h, a_w, wiener)
            per_sm = MAX_THREADS // threads
            assert cs <= MAX_CLUSTER and 64 % cs == 0 and threads % 32 == 0
            assert per_sm * (smem + STATIC_SMEM + SMEM_RESERVED) <= SMEM_PER_SM
            assert smem + STATIC_SMEM <= MAX_SMEM
            awp, ap, ps, cpc = _layout(n_sim, a_h, a_w, cs)
            last = (n_sim - 1) * ap + (a_h - 1) * awp + a_w - 1
            patches = -(-n_sim * a_h * a_w // cs)
            assert last < ps
            assert smem >= 4 * ((2 if wiener else 1) * cpc * ps + 2 * patches)
    assert routed > 0


def _emulate(noisy, basic, bidx, sim_y, sim_x, lvl, mask, ref, sigma, tables,
             *, nd, wiener, doff, cs):
    """The kernel's algorithm in float64: per live group and channel, the
    CTAs' shares of the patches are transformed spatially (column, then
    row) and scattered to the owners of their coefficients; each CTA runs
    the angular, stack, shrink and inverse passes on its slice alone; the
    weight comes from the partials summed in rank order; each CTA reads its
    patches back, inverts them (row, then column) and aggregates."""
    n_c, a, _, _ = noisy.shape
    n_t, n_sim = sim_y.shape
    gt, a_h, a_w = tables.gt, tables.a_h, tables.a_w
    awp, ap, ps, cpc = _layout(n_sim, a_h, a_w, cs)

    def ang(m, s):
        return torch.eye(s, dtype=torch.float64) if m is None else m

    f4s, i4s = ang(gt.f4s, a_h), ang(gt.i4s, a_h)
    f4t, i4t = ang(gt.f4t, a_w), ang(gt.i4t, a_w)
    nsel = 2 * nd + 1
    c_ang = nd * nsel + nd
    regions = 2 if wiener else 1
    cf = torch.arange(64)
    owner, lc = cf // cpc, cf % cpc
    ky = torch.arange(K)[:, None]
    kx = torch.arange(K)[None, :]
    num = torch.zeros_like(noisy)
    wden = torch.zeros_like(noisy)
    for t in range(n_t):
        if not bool(mask[t].any()):
            continue
        lv = int(lvl[t])
        ns = 1 << lv
        n_p = ns * a
        share = -(-n_p // cs)
        pp = torch.arange(n_p)
        n, sai = pp // a, pp % a
        sy, sx = sim_y[t, n].long(), sim_x[t, n].long()
        d = (bidx[sai, sy, sx] if doff is None else doff[t, n, sai]).long()
        d = torch.where(sai == ref, c_ang, d)
        oy, ox = sy + d // nsel - nd, sx + d % nsel - nd
        colx = n * ap + (sai // a_w) * awp + sai % a_w
        yy, xx = oy[:, None, None] + ky, ox[:, None, None] + kx
        ranks = [slice(r * share, min(n_p, (r + 1) * share))
                 for r in range(cs)]
        for c in range(n_c):
            sig = float(sigma[c])
            sl = torch.full((cs, regions, cpc, ps), float("nan"),
                            dtype=torch.float64)
            for g, src in enumerate((noisy, basic)[:regions]):
                for mine in ranks:
                    x = src[c, sai[mine, None, None], yy[mine], xx[mine]]
                    y = torch.einsum("ui,pij->puj", gt.f2, x)
                    z = torch.einsum("vj,puj->puv", gt.f2, y)
                    sl[owner[None], g, lc[None], colx[mine, None]] = (
                        z.reshape(-1, 64))
            view = sl[..., :n_sim * ap].view(cs, regions, cpc, n_sim, a_h,
                                              awp)
            v = view[:, :, :, :ns, :, :a_w]
            v = torch.einsum("sq,rgcnqt->rgcnst", f4s, v)
            v = torch.einsum("tq,rgcnsq->rgcnst", f4t, v)
            sf = gt.stack_f[lv, :ns, :ns]
            y = torch.einsum("qn,rcnst->rcqst", sf, v[:, 0])
            if wiener:
                b = torch.einsum("qn,rcnst->rcqst", sf, v[:, 1])
                om = b * b / (b * b + sig * sig)
                part = (om * om).sum(dim=(1, 2, 3, 4))
                y = y * om
            else:
                keep = y.abs() >= LAMBDA * sig
                part = keep.sum(dim=(1, 2, 3, 4)).double()
                y = y * keep
            y = torch.einsum("qn,rcnst->rcqst", gt.stack_i[lv, :ns, :ns], y)
            y = torch.einsum("sq,rcnqt->rcnst", i4s, y)
            view[:, 0, :, :ns, :, :a_w] = torch.einsum("tq,rcnsq->rcnst",
                                                       i4t, y)
            s = 0.0
            for r in range(cs):
                s += float(part[r])
            floor = 1e-30 if wiener else 1.0
            w = 1.0 / (sig * sig * max(s, floor)) if s > 0 else 1.0
            for mine in ranks:
                z = sl[owner[None], 0, lc[None], colx[mine, None]]
                r_ = torch.einsum("jv,puv->puj", gt.i2, z.view(-1, K, K))
                est = torch.einsum("iu,puj->pij", gt.i2, r_)
                live = mask[t, n[mine]]
                s_ = sai[mine][live]
                num[c].index_put_((s_[:, None, None], yy[mine][live],
                                   xx[mine][live]),
                                  est[live] * (w * tables.kaiser),
                                  accumulate=True)
                wden[c].index_put_((s_, oy[mine][live], ox[mine][live]),
                                   torch.full(s_.shape, w,
                                              dtype=torch.float64),
                                   accumulate=True)
    return num, wden


@pytest.fixture(scope="module")
def lf_pair():
    """Half-flat content, so the flat mask kills some groups."""
    out = {}
    for grid in GRIDS:
        clean = synthetic_lf_multi(*grid, H, W, C, disps=(0.0, 2.0), seed=0,
                                   blob_frac=0.25, flat_frac=0.4)
        noisy = add_noise_np(clean, SIGMA, seed=1)
        out[grid] = noisy, clean + add_noise_np(clean * 0, 3.0, seed=2)
    return out


@pytest.mark.parametrize("doff", [False, True], ids=["direct", "doff"])
@pytest.mark.parametrize("wiener", [False, True], ids=["ht", "wiener"])
@pytest.mark.parametrize("n_sim", [4, 8, 16])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cluster_decomposition_matches_plain(lf_pair, grid, n_sim, wiener,
                                             doff):
    sp = _sp(n_sim)
    a_h, a_w = grid
    noisy, basic = lf_pair[grid]
    xp = tden._flat_pad(torch.as_tensor(noisy), sp.pad)
    bp = tden._flat_pad(torch.as_tensor(basic), sp.pad)
    sig = tden._sigma_channels(SIGMA, "rgb", C, "float64")
    lam = 0.0 if wiener else LAMBDA
    step = build_kernel_step(sp, lam, a_h, a_w, H, W, C, wiener, "float64",
                             "cpu", None, "take" if doff else "direct")
    noisy_pl = xp.permute(3, 0, 1, 2).contiguous()
    basic_pl = bp.permute(3, 0, 1, 2).contiguous() if wiener else None
    match0 = (bp if wiener else xp)[..., 0].contiguous()
    ref = a_h * a_w // 2
    sim_y, sim_x, lvl, mask, bidx = step.block_match(
        match0, ref, step.flat_mask(noisy_pl, sig))
    dtab = step.slot_table(bidx, sim_y, sim_x)
    assert (dtab is not None) == doff
    assert 0 < int(mask.any(dim=1).sum()) < mask.shape[0]
    num = torch.zeros_like(noisy_pl)
    wden = torch.zeros_like(noisy_pl)
    fused_group_step_plain(noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask,
                           ref, sig, step.tables, num, wden, k=K, nd=1,
                           lambda_3d=lam, wiener=wiener, doff=dtab)
    plan_cs = group_plan(n_sim, a_h, a_w, wiener)[0]
    for cs in sorted({plan_cs, 4, 16}):
        en, ed = _emulate(noisy_pl, basic_pl, bidx, sim_y, sim_x, lvl, mask,
                          ref, sig, step.tables, nd=1, wiener=wiener,
                          doff=dtab, cs=cs)
        for got, want in ((en, num), (ed, wden)):
            scale = float(want.abs().max())
            assert scale > 0
            assert float((got - want).abs().max()) <= 1e-12 * scale, cs
