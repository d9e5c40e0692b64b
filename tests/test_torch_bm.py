"""Block matching: the port's plain versions (the twins of its CUDA kernels)
against the JAX reference and the reference's Pallas kernels run in
interpret mode, integer-equal in float64 on a small plane."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.kernels import bm as jbm
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.lf.noise import add_noise_np
from lfbm5d_tpu.lf.pad import ind_initialize, pad_lf
from lfbm5d_tpu.ops import distances as jd
from lfbm5d_tpu.ops.match import select_similar as j_select
from lfbm5d_torch.kernels.bm import cross_argmin_all_kernel, self_distances_kernel
from lfbm5d_torch.ops import distances as td
from lfbm5d_torch.ops.match import select_similar as t_select

torch.set_num_threads(2)

K, N, ND = 8, 4, 1
H, W = 30, 38  # padded by N + ND: 40 x 48 planes


@pytest.fixture(scope="module")
def planes():
    clean = synthetic_lf(2, 2, H, W, channels=1, disp_bg=1, disp_fg=2, seed=3)
    padded = pad_lf(add_noise_np(clean, 20.0, seed=4), N + ND)
    return padded[..., 0].reshape(4, H + 2 * (N + ND), W + 2 * (N + ND))


def _grid():
    return (ind_initialize(H, K, 3) + N + ND, ind_initialize(W, K, 3) + N + ND)


def test_self_distances_equal_reference_and_interpret_kernel(planes):
    ys, xs = _grid()
    for r in range(planes.shape[0]):
        got = td.self_distances(torch.as_tensor(planes[r]), ys, xs, K, N)
        want = np.asarray(jd.self_distances(jnp.asarray(planes[r]), ys, xs,
                                            K, N))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    kern = np.asarray(jbm.self_distances_kernel(
        jnp.asarray(planes[0]), tuple(int(v) for v in ys),
        tuple(int(v) for v in xs), K, N, interpret=True,
    ))
    np.testing.assert_array_equal(
        td.self_distances(torch.as_tensor(planes[0]), ys, xs, K, N).numpy(),
        kern,
    )


def test_cross_argmin_all_equals_reference_and_interpret_kernel(planes):
    a, hp, wp = planes.shape
    got = td.cross_argmin_all(torch.as_tensor(planes[1]),
                              torch.as_tensor(planes), K, ND)
    assert got.shape == (a, hp - K + 1, wp - K + 1)
    for ai in range(a):
        want = np.asarray(jd.cross_argmin(jnp.asarray(planes[1]),
                                          jnp.asarray(planes[ai]), K, ND))
        np.testing.assert_array_equal(got[ai].numpy(), want)
    # the Pallas kernel's layout: others zero-extended by nd and lane-padded,
    # the reference origin-aligned (pipeline/engine.py)
    wq = -(-(wp + 2 * ND) // 128) * 128
    others = jnp.pad(jnp.asarray(planes), ((0, 0), (ND, ND),
                                           (ND, wq - wp - ND)))
    ref = jnp.pad(jnp.asarray(planes[1]), ((0, 2 * ND), (0, wq - wp)))
    kern = np.asarray(jbm.cross_argmin_all_kernel(ref, others, K, ND,
                                                  interpret=True))
    np.testing.assert_array_equal(got.numpy(), kern[:, :, :wp - K + 1])


@pytest.mark.parametrize("tau,n_sim", [(2500.0, 8), (400.0, 8), (0.0, 4),
                                       (2500.0, 16)])
def test_select_similar_equal(planes, tau, n_sim):
    ys, xs = _grid()
    d = td.self_distances(torch.as_tensor(planes[2]), ys, xs, K, N)
    order, lvl, mask = t_select(d, N, tau, n_sim)
    jo, jl, jm = j_select(jnp.asarray(d.numpy()), N, tau, n_sim)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


def test_kernel_wrappers_take_plain_versions_on_cpu(planes):
    ys, xs = _grid()
    p = torch.as_tensor(planes, dtype=torch.float32)
    np.testing.assert_array_equal(
        self_distances_kernel(p[0], ys, xs, K, N).numpy(),
        td.self_distances(p[0], ys, xs, K, N).numpy(),
    )
    np.testing.assert_array_equal(
        cross_argmin_all_kernel(p[0], p, K, ND).numpy(),
        td.cross_argmin_all(p[0], p, K, ND).numpy(),
    )
    assert self_distances_kernel.launches == 0
    assert cross_argmin_all_kernel.launches == 0


def test_kernel_wrappers_raise_off_cpu_without_cuda():
    """A non-CPU tensor never falls back to the plain version."""
    meta = torch.empty((40, 48), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        self_distances_kernel(meta, [5], [5], K, N)
    with pytest.raises(ValueError, match="CUDA"):
        cross_argmin_all_kernel(meta, meta[None], K, ND)


WIDE = [(8, 2), (4, 2), (8, 1)]  # (n, nd): the `fast` and `default` windows


def _wide_planes(n, nd):
    clean = synthetic_lf(2, 2, H, W, channels=1, disp_bg=1, disp_fg=2, seed=5)
    padded = pad_lf(add_noise_np(clean, 20.0, seed=6), n + nd)
    return padded[..., 0].reshape(4, H + 2 * (n + nd), W + 2 * (n + nd))


@pytest.mark.parametrize("n,nd", WIDE)
def test_self_distances_wide_windows_equal_reference(n, nd):
    """Integer-equal in float64 to the XLA scan and the interpret kernel
    at the wider search windows."""
    planes = _wide_planes(n, nd)
    assert planes.dtype == np.float64
    ys = ind_initialize(H, K, 3) + n + nd
    xs = ind_initialize(W, K, 3) + n + nd
    got = td.self_distances(torch.as_tensor(planes[1]), ys, xs, K, n).numpy()
    want = np.asarray(jd.self_distances(jnp.asarray(planes[1]), ys, xs, K, n))
    np.testing.assert_array_equal(got, want)
    kern = np.asarray(jbm.self_distances_kernel(
        jnp.asarray(planes[1]), tuple(int(v) for v in ys),
        tuple(int(v) for v in xs), K, n, interpret=True,
    ))
    np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("n,nd", WIDE)
def test_cross_argmin_wide_windows_equal_reference(n, nd):
    planes = _wide_planes(n, nd)
    a, hp, wp = planes.shape
    got = td.cross_argmin_all(torch.as_tensor(planes[3]),
                              torch.as_tensor(planes), K, nd).numpy()
    for ai in range(a):
        want = np.asarray(jd.cross_argmin(jnp.asarray(planes[3]),
                                          jnp.asarray(planes[ai]), K, nd))
        np.testing.assert_array_equal(got[ai], want)
    wq = -(-(wp + 2 * nd) // 128) * 128
    others = jnp.pad(jnp.asarray(planes), ((0, 0), (nd, nd),
                                           (nd, wq - wp - nd)))
    ref = jnp.pad(jnp.asarray(planes[3]), ((0, 2 * nd), (0, wq - wp)))
    kern = np.asarray(jbm.cross_argmin_all_kernel(ref, others, K, nd,
                                                  interpret=True))
    np.testing.assert_array_equal(got, kern[:, :, :wp - K + 1])
