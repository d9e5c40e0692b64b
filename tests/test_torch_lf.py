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
