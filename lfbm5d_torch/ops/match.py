"""Similar-patch selection: dense top-N with tau threshold and pow2 truncation.

Counterpart of `lfbm5d_tpu.ops.match`. Candidates sort by (distance,
is-not-self, row-major window index): a STABLE argsort with the self
candidate's key set to -1 (its true distance is 0, and tau_match >= 0 always
admits it) yields that order with one sort.
"""

from __future__ import annotations

import torch

from lfbm5d_torch.ops.distances import DIST_QUANT, center_index


def select_similar(dists: torch.Tensor, n_search: int, tau_match: float,
                   n_sim: int):
    """dists: [T, (2n+1)^2] quantized int32 SSDs, row-major candidate order.

    Returns (order [T, n_sim] int64 window-candidate indices in spec order,
    lvl [T] int32 with stack size = 2**lvl, mask [T, n_sim] bool marking the
    live stack slots).
    """
    adj = dists.clone()
    adj[:, center_index(n_search)] = -1
    order = torch.argsort(adj, dim=1, stable=True)[:, :n_sim]
    tau_q = round(tau_match * DIST_QUANT)
    # the tau count is permutation-invariant: take it from the UNSORTED rows
    count = torch.clamp((dists <= tau_q).sum(dim=1), max=n_sim)  # >= 1
    lvl = torch.zeros(dists.shape[0], dtype=torch.int32, device=dists.device)
    s = 2
    while s <= n_sim:
        lvl = lvl + (count >= s).to(torch.int32)
        s *= 2
    slots = torch.arange(n_sim, device=dists.device)
    mask = slots[None, :] < (1 << lvl.long())[:, None]
    return order, lvl, mask
