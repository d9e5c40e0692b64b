"""Shrinkage and the flat-region mask/fallback against the JAX reference
(CPU, float64)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.pad import ind_initialize, pad_lf
from lfbm5d_tpu.ops import flat as jflat
from lfbm5d_tpu.ops import shrinkage as jsh
from lfbm5d_tpu.transforms import matrices as jm
from lfbm5d_torch.ops import flat as tflat
from lfbm5d_torch.ops import shrinkage as tsh

torch.set_num_threads(2)


def _spec(seed):
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((3, 4, 2, 3, 8, 8, 3)) * 60.0
    spec[1] = 0.0  # an all-zero group: weight 1.0
    return spec


SIGMA = np.array([25.0, 12.5, 40.0])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_ht_shrink_matches():
    spec = _spec(0)
    tf, tw = tsh.ht_shrink(torch.as_tensor(spec), torch.as_tensor(SIGMA), 2.7)
    jf, jw = jsh.ht_shrink(jnp.asarray(spec), jnp.asarray(SIGMA), 2.7)
    _close(tf, jf)
    _close(tw, jw)


def test_wiener_shrink_matches():
    spec, basic = _spec(1), _spec(2)
    tf, tw = tsh.wiener_shrink(torch.as_tensor(spec), torch.as_tensor(basic),
                               torch.as_tensor(SIGMA))
    jf, jw = jsh.wiener_shrink(jnp.asarray(spec), jnp.asarray(basic),
                               jnp.asarray(SIGMA))
    _close(tf, jf)
    _close(tw, jw)


def test_sd_weight_matches():
    est = _spec(3) + 3.0
    lvl = np.array([0, 1, 2], np.int32)
    tw = tsh.sd_weight(torch.as_tensor(est), torch.as_tensor(lvl), 6, 8)
    jw = jsh.sd_weight(jnp.asarray(est), jnp.asarray(lvl), 6, 8)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12)


@pytest.mark.parametrize("flat_tau", [0.9, 1.3, 3.0])
def test_flat_ref_mask_equal(flat_tau):
    """Half-flat content so the mask has both values."""
    from lfbm5d_tpu.lf.synth import synthetic_lf_multi

    clean = synthetic_lf_multi(3, 3, 30, 36, 1, disps=(0.0, 2.0), seed=0,
                               blob_frac=0.25, flat_frac=0.4)
    noisy = pad_lf(add_noise_np(clean, 20.0, seed=1), 5)
    planes = noisy[..., 0].reshape(9, 40, 46)
    ys = ind_initialize(30, 8, 4) + 5
    xs = ind_initialize(36, 8, 4) + 5
    got = tflat.flat_ref_mask(torch.as_tensor(planes), ys, xs, 8, flat_tau,
                              torch.tensor(20.0, dtype=torch.float64))
    want = jflat.flat_ref_mask(jnp.asarray(planes), ys, xs, 8, flat_tau,
                               jnp.asarray(20.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pilot", [False, True], ids=["no-pilot", "pilot"])
@pytest.mark.parametrize("tau_2d", ["dct", "bior"])
def test_fallback_shrink_2d_matches(pilot, tau_2d):
    """Odd extents exercise the symmetric block padding."""
    clean = synthetic_lf(3, 2, 21, 26, channels=3, seed=5)
    x = add_noise_np(clean, 25.0, seed=6)
    basic = clean + 2.0 if pilot else None
    f2, i2 = jm.transform_pair(tau_2d, 8)
    got = tflat.fallback_shrink_2d(
        torch.as_tensor(x), torch.as_tensor(SIGMA), torch.as_tensor(f2),
        torch.as_tensor(i2), 2.7,
        None if basic is None else torch.as_tensor(basic),
    )
    want = jflat.fallback_shrink_2d(
        jnp.asarray(x), jnp.asarray(SIGMA), jnp.asarray(f2), jnp.asarray(i2),
        2.7, None if basic is None else jnp.asarray(basic),
    )
    assert got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("form", ["batch", "batched"])
def test_self_distances_batch_forms_match_reference(form):
    """self_distances_batch (every plane of a stack) and
    self_distances_batched (the displacement-batched form), float64."""
    from lfbm5d_tpu.lf.pad import pad_lf as np_pad
    from lfbm5d_tpu.ops import distances as jd
    from lfbm5d_torch.ops import distances as td

    clean = synthetic_lf(2, 2, 20, 24, channels=1, seed=3)
    planes = np_pad(add_noise_np(clean, 20.0, seed=4), 4)[..., 0].reshape(
        4, 28, 32)
    ys = ind_initialize(20, 8, 3) + 4
    xs = ind_initialize(24, 8, 3) + 4
    if form == "batch":
        got = td.self_distances_batch(torch.as_tensor(planes), ys, xs, 8, 4)
        want = jd.self_distances_batch(jnp.asarray(planes), jnp.asarray(ys),
                                       jnp.asarray(xs), 8, 4)
    else:
        got = td.self_distances_batched(torch.as_tensor(planes[1]), ys, xs,
                                        8, 4)
        want = jd.self_distances_batched(jnp.asarray(planes[1]), ys, xs, 8,
                                         4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
