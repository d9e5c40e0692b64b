"""lfbm5d_torch.lf: symmetric pad and PSNR (CPU)."""

import numpy as np
import pytest
import torch

from lfbm5d_tpu.lf import psnr as np_psnr
from lfbm5d_tpu.lf.pad import pad_lf as np_pad_lf
from lfbm5d_torch.lf import pad_lf, psnr, symmetric_pad

torch.set_num_threads(2)


@pytest.mark.parametrize("pad", [0, 1, 3, 7, 12, 25])
def test_symmetric_pad_equals_numpy(pad):
    """Edge-inclusive mirroring, including pads longer than the axis."""
    x = np.random.default_rng(pad).standard_normal((2, 9, 11, 3))
    got = symmetric_pad(torch.as_tensor(x), pad, (1, 2)).numpy()
    want = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                  mode="symmetric")
    np.testing.assert_array_equal(got, want)


def test_symmetric_pad_asymmetric_widths():
    x = np.arange(5.0)
    got = symmetric_pad(torch.as_tensor(x), (0, 3), (0,)).numpy()
    np.testing.assert_array_equal(got, np.pad(x, (0, 3), mode="symmetric"))


def test_pad_lf_matches_reference():
    """Channel count 3 or 8: the axes are named, not guessed."""
    for c in (1, 3, 8):
        lf = np.random.default_rng(c).standard_normal((2, 3, 10, 12, c))
        got = pad_lf(torch.as_tensor(lf), 4).numpy()
        want = np.pad(lf, ((0, 0), (0, 0), (4, 4), (4, 4), (0, 0)),
                      mode="symmetric")
        np.testing.assert_array_equal(got, want)
        if c <= 4:
            np.testing.assert_array_equal(got, np_pad_lf(lf, 4))


def test_psnr_matches_reference():
    rng = np.random.default_rng(3)
    ref = rng.uniform(0, 255, (3, 3, 8, 9, 3))
    pred = ref + rng.normal(0, 20, ref.shape)
    want = np_psnr(np.clip(pred, 0, 255), ref)
    assert abs(psnr(torch.as_tensor(pred), ref) - want) < 1e-10
    assert psnr(torch.as_tensor(ref), ref) == float("inf")


@pytest.mark.parametrize("space", ["opp", "yuv", "ycbcr", "rgb"])
def test_color_transforms_match_reference(space):
    """rgb_to_space / space_to_rgb: arrays as the reference's, tensors on
    the tensor's dtype and device, grey passes through."""
    from lfbm5d_tpu.lf import rgb_to_space as j_fwd
    from lfbm5d_tpu.lf import space_to_rgb as j_inv
    from lfbm5d_torch.lf import rgb_to_space, space_to_rgb

    lf = np.random.default_rng(4).uniform(0, 255, (2, 3, 5, 6, 3))
    want = j_fwd(lf, space)
    np.testing.assert_array_equal(rgb_to_space(lf, space), want)
    got = rgb_to_space(torch.as_tensor(lf), space)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(space_to_rgb(want, space),
                                  j_inv(want, space))
    back = space_to_rgb(torch.as_tensor(want).float(), space)
    assert back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), lf, rtol=0, atol=1e-3)
    grey = torch.as_tensor(lf[..., :1])
    assert rgb_to_space(grey, space) is grey


def test_psnr_device_matches_reference():
    """psnr_device clips and reduces on the tensor's device; the
    reference's reduces in f32 (agreement to 1e-4 dB)."""
    from lfbm5d_tpu.lf import psnr_device as j_psnr_device
    from lfbm5d_torch.lf import psnr_device

    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 255, (3, 3, 8, 9, 3))
    pred = ref + rng.normal(0, 30, ref.shape)  # beyond [0, 255]: clipped
    got = psnr_device(torch.as_tensor(pred, dtype=torch.float32), ref)
    assert abs(got - j_psnr_device(pred, ref)) < 1e-4
    assert abs(got - np_psnr(np.clip(pred, 0, 255), ref)) < 1e-4


def test_add_noise_statistics():
    """add_noise(generator, lf, sigma): float32 on the generator's device,
    zero-mean AWGN of std sigma (the reference's draws from a JAX key, so
    only the statistics compare), reproducible from the generator's
    seed."""
    import jax

    from lfbm5d_tpu.lf import add_noise as j_add_noise
    from lfbm5d_torch.lf import add_noise

    lf = np.full((4, 4, 32, 32, 3), 100.0)
    sigma = 25.0
    got = add_noise(torch.Generator().manual_seed(3), lf, sigma)
    assert got.dtype == torch.float32 and got.shape == lf.shape
    d = got.double() - 100.0
    tol = 4 * sigma / np.sqrt(d.numel())
    assert abs(float(d.mean())) < tol
    assert abs(float(d.std()) - sigma) < 0.02 * sigma
    jd = np.asarray(j_add_noise(jax.random.PRNGKey(3), lf, sigma)) - 100.0
    assert abs(float(d.std()) - float(jd.std())) < 0.02 * sigma
    again = add_noise(torch.Generator().manual_seed(3), lf, sigma)
    assert torch.equal(got, again)
    other = add_noise(torch.Generator().manual_seed(4), lf, sigma)
    assert not torch.equal(got, other)
