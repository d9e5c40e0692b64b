"""The port's own copies of the reference's numpy-only modules (config,
lf.color, lf.synth, lf.noise, the grids of lf.pad) equal the reference."""

import dataclasses

import numpy as np
import pytest
import torch

from lfbm5d_tpu import config as jcfg
from lfbm5d_tpu.lf import color as jcolor
from lfbm5d_tpu.lf import noise as jnoise
from lfbm5d_tpu.lf import pad as jpad
from lfbm5d_tpu.lf import synth as jsynth
from lfbm5d_torch import config as tcfg
from lfbm5d_torch.lf import color as tcolor
from lfbm5d_torch.lf import noise as tnoise
from lfbm5d_torch.lf import pad as tpad
from lfbm5d_torch.lf import synth as tsynth

torch.set_num_threads(2)


def test_presets_and_schedules_equal():
    assert tcfg.PRESETS == jcfg.PRESETS
    assert tcfg.SR_SCHEDULES == jcfg.SR_SCHEDULES


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
@pytest.mark.parametrize("sigma", [10.0, 25.0])
def test_preset_denoise_params_equal(preset, sigma):
    want = dataclasses.asdict(jcfg.preset_denoise_params(preset, sigma))
    got = dataclasses.asdict(tcfg.preset_denoise_params(preset, sigma))
    assert got == want


def test_defaults_and_step_fields_equal():
    assert ([f.name for f in dataclasses.fields(tcfg.StepParams)]
            == [f.name for f in dataclasses.fields(jcfg.StepParams)])
    assert (dataclasses.asdict(tcfg.DenoiseParams())
            == dataclasses.asdict(jcfg.DenoiseParams()))
    assert tcfg.StepParams(n_search=5, n_disp=2).pad == 7
    with pytest.raises(ValueError, match="power of two"):
        tcfg.StepParams(n_sim=6)


def test_from_reference_round_trips():
    ref = jcfg.preset_denoise_params("robust", 20.0, chunk=64).replace(
        color_space="yuv")
    got = tcfg.from_reference(ref)
    assert type(got) is tcfg.DenoiseParams
    assert type(got.ht) is tcfg.StepParams
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert tcfg.from_reference(got) == got
    sp = jcfg.StepParams(n_sim=4, use_sd=True, tau_2d="bior")
    assert dataclasses.asdict(tcfg.from_reference(sp)) == (
        dataclasses.asdict(sp))


@pytest.mark.parametrize("space", ["opp", "yuv", "ycbcr", "rgb"])
def test_color_bit_equal(space):
    np.testing.assert_array_equal(tcolor.color_matrix(space),
                                  jcolor.color_matrix(space))
    np.testing.assert_array_equal(tcolor.channel_sigma_scales(space),
                                  jcolor.channel_sigma_scales(space))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_lf_bit_equal(seed):
    kw = dict(a_h=3, a_w=4, h=20, w=24, channels=3, disp_bg=1, disp_fg=2,
              seed=seed, flat_frac=0.2 * (seed % 2))
    np.testing.assert_array_equal(tsynth.synthetic_lf(**kw),
                                  jsynth.synthetic_lf(**kw))


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_lf_multi_bit_equal(seed):
    kw = dict(a_h=3, a_w=3, h=18, w=22, channels=2, disps=(0.0, 1.5, 3.0),
              seed=seed, flat_frac=0.3, texture_grad=0.5, blob_frac=0.3)
    np.testing.assert_array_equal(tsynth.synthetic_lf_multi(**kw),
                                  jsynth.synthetic_lf_multi(**kw))


@pytest.mark.parametrize("seed,kind", [(0, "pcg64"), (100, "pcg64"),
                                       (7, "mt19937")])
def test_add_noise_bit_equal(seed, kind):
    x = np.linspace(0.0, 255.0, 2 * 3 * 5 * 4).reshape(2, 3, 5, 4)
    np.testing.assert_array_equal(tnoise.add_noise_np(x, 25.0, seed, kind),
                                  jnoise.add_noise_np(x, 25.0, seed, kind))


@pytest.mark.parametrize("size,k,p", [(434, 8, 8), (625, 8, 3), (12, 8, 3),
                                      (17, 1, 4), (9, 1, 4), (8, 8, 3)])
def test_ind_initialize_equal(size, k, p):
    np.testing.assert_array_equal(tpad.ind_initialize(size, k, p),
                                  jpad.ind_initialize(size, k, p))


@pytest.mark.parametrize("a_h,a_w,p_ang", [(9, 9, 4), (17, 17, 4),
                                           (17, 17, 1), (3, 5, 2)])
def test_ref_sai_grid_equal(a_h, a_w, p_ang):
    got = tpad.ref_sai_grid(a_h, a_w, p_ang)
    np.testing.assert_array_equal(got, jpad.ref_sai_grid(a_h, a_w, p_ang))
    if (a_h, a_w, p_ang) == (17, 17, 4):
        assert len(got) == 25
