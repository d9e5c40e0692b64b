"""The port's SR path on the CPU: the resize operators against
`lfbm5d_tpu.lf.resize` (float64, to 1e-12), `run_sr` against the reference's
float64 SR oracle (to 1e-8), and the SR entry points' contract."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.config import SRParams, StepParams
from lfbm5d_tpu.lf import resize as jresize
from lfbm5d_tpu.lf import synthetic_lf
from lfbm5d_tpu.oracle.oracle import oracle_sr
from lfbm5d_tpu.pipeline.sr import sigma_schedule as j_sigma_schedule
from lfbm5d_torch import LFSuperResolver, psnr_device
from lfbm5d_torch.config import from_reference
from lfbm5d_torch.lf import resize as tresize
from lfbm5d_torch.pipeline import sr as tsr

torch.set_num_threads(2)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 3, 7, 9, 2), (1, 2, 5, 11, 3)])
def test_upsample_equals_jax_cubic(scale, shape):
    x = np.random.default_rng(scale).random(shape) * 255.0
    want = np.asarray(jresize.upsample(jnp.asarray(x), scale))
    got = tresize.upsample(torch.as_tensor(x), scale)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("blur", [0.0, 0.8])
def test_downsample_equals_jax(scale, blur):
    x = np.random.default_rng(10 + scale).random((2, 2, 5 * scale,
                                                  7 * scale, 2)) * 255.0
    want = np.asarray(jresize.downsample(jnp.asarray(x), scale, blur))
    got = tresize.downsample(torch.as_tensor(x), scale, blur)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="divisible"):
        tresize.downsample(torch.as_tensor(x[:, :, 1:]), scale)


@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.5, 3.0])
def test_gaussian_blur_equals_jax(sigma):
    """Reflect borders at any radius (sigma 3: a radius beyond the 7 rows)."""
    x = np.random.default_rng(3).random((2, 1, 7, 9, 2)) * 255.0
    want = np.asarray(jresize.gaussian_blur(jnp.asarray(x), sigma))
    got = tresize.gaussian_blur(torch.as_tensor(x), sigma)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_upsample_is_not_torch_bicubic():
    """F.interpolate's bicubic (a = -0.75, clamped border) is another
    function: the port must not use it."""
    x = torch.as_tensor(np.random.default_rng(4).random((1, 1, 8, 8, 1))
                        * 255.0)
    ours = tresize.upsample(x, 2)[0, 0, :, :, 0]
    theirs = torch.nn.functional.interpolate(
        x[0, 0, :, :, 0][None, None], scale_factor=2, mode="bicubic",
        align_corners=False)[0, 0]
    assert float((ours - theirs).abs().max()) > 1e-3


def _tiny_sr(n_iter=2):
    tiny = dict(n_sim=4, n_search=3, n_disp=1, k=8, p=4)
    return SRParams(
        scale=2, n_iter=n_iter, sigma_init=6.0, sigma_final=2.0,
        ht=StepParams(tau_match=2500.0, **tiny),
        wiener=StepParams(tau_match=400.0, **tiny), chunk=32,
    )


@pytest.fixture(scope="module")
def sr_case():
    """tests/test_sr.py's oracle parity case."""
    clean = synthetic_lf(2, 2, 24, 24, channels=1, disp_bg=1, seed=9)
    lr = np.array(jresize.downsample(jnp.asarray(clean), 2))
    params = _tiny_sr()
    return clean, lr, params, oracle_sr(lr, params)


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_run_sr_f64_matches_oracle(sr_case, engine):
    clean, lr, params, hr_o = sr_case
    hr = tsr.run_sr(lr, from_reference(params), dtype="float64",
                    engine=engine, device="cpu")
    assert hr.shape == clean.shape and hr.dtype == torch.float64
    assert np.abs(hr.numpy() - hr_o).max() < 1e-8


def test_sigma_schedule_equals_reference():
    params = _tiny_sr(5).replace(sigma_init=12.0, sigma_final=1.0)
    np.testing.assert_array_equal(tsr.sigma_schedule(from_reference(params)),
                                  j_sigma_schedule(params))


def test_run_sr_routes_through_run_bm5d(sr_case, monkeypatch):
    """Every iteration filters through run_bm5d with the schedule's sigma_c
    and params.sigma 0; on_iteration sees the HR tensor of each."""
    _, lr, params, _ = sr_case
    calls, seen = [], []
    real = tsr.run_bm5d

    def spy(lf, dn, dtype="float32", engine="auto", sigma_c=None, **kw):
        calls.append((dn.sigma, sigma_c.clone()))
        return real(lf, dn, dtype, engine, sigma_c=sigma_c, **kw)

    monkeypatch.setattr(tsr, "run_bm5d", spy)
    p = from_reference(params.replace(n_iter=3))
    hr = tsr.run_sr(lr, p, on_iteration=lambda i, x: seen.append((i, x)),
                    dtype="float64", device="cpu")
    assert [i for i, _ in seen] == [0, 1, 2]
    assert all(torch.is_tensor(x) for _, x in seen) and seen[-1][1] is hr
    for (sig0, sc), want in zip(calls, tsr.sigma_schedule(p)):
        assert sig0 == 0.0
        np.testing.assert_allclose(sc.numpy(), [want], rtol=1e-12)


def test_super_resolver_beats_bicubic(sr_case):
    clean, lr, params, _ = sr_case
    model = LFSuperResolver(from_reference(params.replace(n_iter=3)),
                            dtype="float64", device="cpu")
    hr = model(lr)
    bicubic = tresize.upsample(torch.as_tensor(lr), 2)
    assert psnr_device(hr, clean) > psnr_device(bicubic, clean)
    np.testing.assert_array_equal(model.upscale(lr), hr.numpy())
