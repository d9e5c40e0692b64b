"""The port's public contracts against the reference's (CPU): `psnr`
unclipped and `psnr_device` clipped, `symmetric_pad` without named axes,
`upsample` with every method of jax.image.resize, and every public name of
the reference's subpackages."""

import ast
import importlib
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lfbm5d_tpu.lf import metrics as jmetrics
from lfbm5d_tpu.lf import pad as jpad
from lfbm5d_tpu.lf import resize as jresize
from lfbm5d_torch.lf import metrics as tmetrics
from lfbm5d_torch.lf import pad as tpad
from lfbm5d_torch.lf import resize as tresize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# jax.image.resize's method names and aliases
METHODS = ["nearest", "linear", "bilinear", "trilinear", "triangle", "cubic",
           "bicubic", "tricubic", "lanczos3", "lanczos5"]
# reference names the port does not carry: the TPU mesh helpers, which
# parallel.make_devices replaces, and the float64 oracle (the port's tests
# import it from the reference)
NOT_PORTED = {("parallel", "ensure_virtual_devices"),
              ("parallel", "make_mesh")}
NOT_PORTED_PACKAGES = {"oracle"}


@pytest.fixture(scope="module")
def noisy_pair():
    """A noisy LF with samples outside [0, 255] (sigma 30 on [0, 255])."""
    rng = np.random.default_rng(7)
    clean = rng.uniform(0, 255, (3, 4, 9, 11, 3))
    noisy = clean + rng.normal(0, 30, clean.shape)
    assert (noisy < 0).any() and (noisy > 255).any()
    return noisy, clean


def test_psnr_is_unclipped_as_the_reference(noisy_pair):
    noisy, clean = noisy_pair
    want = jmetrics.psnr(noisy, clean)
    got = tmetrics.psnr(torch.as_tensor(noisy), clean)
    assert abs(got - want) <= 1e-12
    assert tmetrics.psnr(noisy, clean) == got  # arrays as the reference's
    clipped = tmetrics.psnr_device(torch.as_tensor(noisy), clean)
    assert clipped - got > 0.1  # the clip removes error there
    want_clipped = jmetrics.psnr(np.clip(noisy, 0, 255), clean)
    assert abs(clipped - want_clipped) <= 1e-12


def test_psnr_device_matches_reference_psnr_device(noisy_pair):
    """The reference reduces in f32 (agreement to 1e-4 dB)."""
    noisy, clean = noisy_pair
    got = tmetrics.psnr_device(torch.as_tensor(noisy, dtype=torch.float32),
                               clean)
    assert abs(got - jmetrics.psnr_device(noisy, clean)) < 1e-4
    assert tmetrics.psnr_device(torch.as_tensor(clean), clean) == float("inf")
    assert tmetrics.psnr(clean, clean) == float("inf")


@pytest.mark.parametrize("shape", [(9, 11), (9, 11, 1), (9, 11, 4),
                                   (2, 3, 9, 11, 3), (9, 11, 5),
                                   (2, 9, 11, 5)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pad", [1, 4, 13])
def test_symmetric_pad_guesses_axes_as_the_reference(shape, pad):
    """Without axes: the two axes before a trailing channel axis of size
    <= 4 (3 or more axes), else the last two; tensors and arrays."""
    x = np.random.default_rng(pad).standard_normal(shape)
    want = jpad.symmetric_pad(x, pad)
    np.testing.assert_array_equal(tpad.symmetric_pad(x, pad).numpy(), want)
    got = tpad.symmetric_pad(torch.as_tensor(x), pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_upsample_every_method_equals_jax(method, scale):
    """Float64, odd and even sizes, against jax.image.resize through the
    reference's upsample."""
    x = np.random.default_rng(scale).uniform(0, 255, (2, 3, 7, 10, 3))
    want = np.asarray(jresize.upsample(jnp.asarray(x), scale, method))
    got = tresize.upsample(torch.as_tensor(x), scale, method)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_upsample_unknown_method_raises():
    x = torch.zeros((1, 1, 4, 4, 1))
    for method in ("bicubic2", "area", "Cubic"):
        with pytest.raises(ValueError):
            jresize.upsample(jnp.zeros((1, 1, 4, 4, 1)), 2, method)
        with pytest.raises(ValueError):
            tresize.upsample(x, 2, method)
    with pytest.raises(ValueError):
        tresize.upsample(x, 1, "area")


def _public_names(path):
    """Names a reference __init__.py binds (from-imports, defs,
    assignments; not the modules it imports), read by AST, without
    importing it."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def _subpackages():
    root = os.path.join(REPO, "lfbm5d_tpu")
    return sorted(d for d in os.listdir(root)
                  if os.path.isfile(os.path.join(root, d, "__init__.py"))
                  and d not in NOT_PORTED_PACKAGES)


@pytest.mark.parametrize("sub", [""] + _subpackages())
def test_port_has_every_public_name_of_the_reference(sub):
    path = os.path.join(REPO, "lfbm5d_tpu", sub, "__init__.py")
    port = importlib.import_module("lfbm5d_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in _public_names(path)
                     if (sub, n) not in NOT_PORTED and not hasattr(port, n))
    assert not missing, (sub, missing)
