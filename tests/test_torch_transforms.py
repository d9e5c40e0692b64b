"""lfbm5d_torch.transforms against the JAX reference (CPU, float64)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import StepParams
from lfbm5d_tpu.transforms import apply as japply
from lfbm5d_torch.config import from_reference
from lfbm5d_tpu.transforms import matrices as jm
from lfbm5d_torch.transforms import apply as tapply
from lfbm5d_torch.transforms import matrices as tm

torch.set_num_threads(2)

MATRIX_CASES = (
    [("dct_matrix", (n,)) for n in (1, 2, 3, 5, 8, 9, 16)]
    + [("haar_matrix", (n,)) for n in (1, 2, 8, 16)]
    + [("hadamard_matrix", (n,)) for n in (1, 2, 8, 16)]
    + [("bior15_matrix", (n,)) for n in (2, 8, 16)]
    + [("transform_pair", (name, 8))
       for name in ("id", "dct", "haar", "hadamard", "bior")]
    + [("stack_matrices", (name, n)) for name in ("haar", "hadamard", "dct")
       for n in (8, 16)]
    + [("kaiser_window", (8,)), ("kaiser_window_1d", (8,)),
       ("kaiser_window", (6, 3.0))]
)


@pytest.mark.parametrize("fn,args", MATRIX_CASES,
                         ids=[f"{f}{a}" for f, a in MATRIX_CASES])
def test_matrices_bit_equal(fn, args):
    want = getattr(jm, fn)(*args)
    got = getattr(tm, fn)(*args)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


STEP_VARIANTS = [
    dict(tau_2d="dct", tau_4d="dct", tau_5d="haar"),
    dict(tau_2d="bior", tau_4d="dct", tau_5d="hadamard"),
    dict(tau_2d="dct", tau_4d="id", tau_5d="dct"),
]


@pytest.mark.parametrize("variant", STEP_VARIANTS,
                         ids=[v["tau_2d"] + "-" + v["tau_4d"] + "-"
                              + v["tau_5d"] for v in STEP_VARIANTS])
def test_forward_inverse_5d_match_jax(variant):
    """3x3 grids: the angular DCT is not symmetric there."""
    sp = StepParams(n_sim=8, k=8, **variant)
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 8, 3, 3, 8, 8, 2)) * 50.0
    lvl = np.array([0, 1, 2, 3], np.int32)
    jgt = japply.GroupTransforms.build(sp, 3, 3, dtype=jnp.float64)
    tgt = tapply.GroupTransforms.build(from_reference(sp), 3, 3,
                                       dtype=torch.float64)
    jf = np.asarray(japply.forward_5d(jnp.asarray(g), jnp.asarray(lvl), jgt))
    tf = tapply.forward_5d(torch.as_tensor(g), torch.as_tensor(lvl).long(),
                           tgt)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-12)
    ji = np.asarray(japply.inverse_5d(jnp.asarray(jf), jnp.asarray(lvl), jgt))
    ti = tapply.inverse_5d(tf, torch.as_tensor(lvl).long(), tgt)
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", STEP_VARIANTS[:2],
                         ids=["dct-haar", "bior-hadamard"])
def test_from_reference_equals_own_constants(variant):
    """The reference's transform constants carried over into tensors are
    the port's own constants."""
    sp = StepParams(n_sim=8, k=8, **variant)
    jgt = japply.GroupTransforms.build(sp, 3, 5, dtype=jnp.float64)
    ref = type("GT", (), {
        f: (None if getattr(jgt, f) is None else np.asarray(getattr(jgt, f)))
        for f in tapply._FIELDS
    })
    got = tapply.from_reference(ref, dtype=torch.float64)
    want = tapply.GroupTransforms.build(from_reference(sp), 3, 5,
                                        dtype=torch.float64)
    for f in tapply._FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert torch.equal(g, w), f
