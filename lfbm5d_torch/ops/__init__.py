from lfbm5d_torch.ops.distances import (  # noqa: F401
    DIST_QUANT,
    cross_argmin,
    cross_argmin_all,
    self_distances,
    self_distances_batch,
    self_distances_batched,
)
from lfbm5d_torch.ops.flat import fallback_shrink_2d, flat_ref_mask  # noqa: F401
from lfbm5d_torch.ops.match import select_similar  # noqa: F401
from lfbm5d_torch.ops.shrinkage import ht_shrink, sd_weight, wiener_shrink  # noqa: F401
