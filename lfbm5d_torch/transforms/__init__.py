from lfbm5d_torch.transforms import matrices  # noqa: F401
from lfbm5d_torch.transforms.apply import (  # noqa: F401
    GroupTransforms,
    forward_5d,
    from_reference,
    inverse_5d,
)
from lfbm5d_torch.transforms.matrices import (  # noqa: F401
    bior15_matrix,
    dct_matrix,
    haar_matrix,
    hadamard_matrix,
    kaiser_window,
    stack_matrices,
    transform_pair,
)
