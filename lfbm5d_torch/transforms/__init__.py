from lfbm5d_torch.transforms import matrices  # noqa: F401
from lfbm5d_torch.transforms.apply import (  # noqa: F401
    GroupTransforms,
    forward_5d,
    from_reference,
    inverse_5d,
)
