"""Transform matrices for the separable 5D group transform.

A numpy-only copy of `lfbm5d_tpu.transforms.matrices` (whose package
`__init__` imports jax), kept bit-equal to it (tests/test_torch_transforms.py).
The reference's transform library (lib_transforms.cpp, SURVEY.md §2 #4)
implements bior1.5 by lifting, Hadamard/Haar in-place, and k x k DCT via FFTW
plans. Here every one of these is a small dense matrix, built once in
float64:

  * dct_matrix(n)      — orthonormal DCT-II (matches scipy.fft.dct norm='ortho')
  * haar_matrix(n)     — orthonormal Haar, n a power of two
  * hadamard_matrix(n) — orthonormal (1/sqrt(n)-scaled) Sylvester Hadamard
  * bior15_matrix(n)   — full multi-level periodized bior1.5 analysis matrix
                         and its exact inverse (biorthogonal synthesis)

`stack_matrices` prepares, for the similarity-stack axis, the transform for
every power-of-two group size 1..N padded into an N x N matrix (zero rows and
columns outside the active block). A group whose stack was truncated to size
s then uses matrix index log2(s): invalid (garbage-gathered) slots are
multiplied by zero columns on the forward pass and receive zeros on the
inverse pass, so no masking of the group tensor itself is ever needed.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# pywt's bior1.5 decomposition low-pass filter (length 10); stable published
# constants of the CDF B-spline 1.5 wavelet.
_BIOR15_DEC_LO = np.array(
    [
        0.016572815184059706,
        -0.016572815184059706,
        -0.12153397801643787,
        0.12153397801643787,
        0.7071067811865476,
        0.7071067811865476,
        0.12153397801643787,
        -0.12153397801643787,
        -0.016572815184059706,
        0.016572815184059706,
    ],
    dtype=np.float64,
)
# Analysis high-pass: Haar pair aligned with the center taps of dec_lo.
_BIOR15_DEC_HI = np.array(
    [0.0, 0.0, 0.0, 0.0, -0.7071067811865476, 0.7071067811865476, 0.0, 0.0, 0.0, 0.0],
    dtype=np.float64,
)


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II: y = D @ x."""
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (j + 0.5) * i / n)
    d[0, :] *= np.sqrt(1.0 / n)
    d[1:, :] *= np.sqrt(2.0 / n)
    return d


@lru_cache(maxsize=None)
def haar_matrix(n: int) -> np.ndarray:
    """Orthonormal Haar matrix for n a power of two."""
    if n & (n - 1):
        raise ValueError(f"Haar size must be a power of two, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        m = h.shape[0]
        top = np.kron(h, np.array([1.0, 1.0]))
        bot = np.kron(np.eye(m), np.array([1.0, -1.0]))
        h = np.vstack([top, bot]) / np.sqrt(2.0)
    return h


@lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Orthonormal Sylvester Hadamard matrix for n a power of two."""
    if n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def _bior15_level(n: int) -> np.ndarray:
    """One periodized analysis level on a length-n signal.

    Rows 0..n/2-1 are the low-pass (dec_lo) rows, rows n/2.. the high-pass
    rows; tap m of output i lands on sample (2i + m - 4) mod n, centering the
    Haar-like pair of center taps on samples (2i, 2i+1).
    """
    if n % 2:
        raise ValueError(f"bior level needs even size, got {n}")
    lo = np.zeros((n // 2, n))
    hi = np.zeros((n // 2, n))
    for i in range(n // 2):
        for m in range(10):
            j = (2 * i + m - 4) % n
            lo[i, j] += _BIOR15_DEC_LO[m]
            hi[i, j] += _BIOR15_DEC_HI[m]
    return np.vstack([lo, hi])


@lru_cache(maxsize=None)
def bior15_matrix(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Full multi-level periodized bior1.5 DWT matrix and its inverse.

    Decomposes down to a single approximation coefficient (log2(n) levels,
    matching the full-depth decomposition of the reference's bior_2d_forward).
    Returns (forward, inverse) with inverse @ forward == I to fp64 precision.
    """
    if n & (n - 1):
        raise ValueError(f"bior1.5 size must be a power of two, got {n}")
    w = np.eye(n)
    size = n
    while size >= 2:
        lvl = np.eye(n)
        lvl[:size, :size] = _bior15_level(size)
        w = lvl @ w
        size //= 2
    wi = np.linalg.inv(w)
    return w, wi


@lru_cache(maxsize=None)
def transform_pair(name: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) matrices for a named 1D transform of size n."""
    if name == "id":
        eye = np.eye(n)
        return eye, eye
    if name == "dct":
        d = dct_matrix(n)
        return d, d.T
    if name == "haar":
        h = haar_matrix(n)
        return h, h.T
    if name == "hadamard":
        h = hadamard_matrix(n)
        return h, h.T
    if name == "bior":
        return bior15_matrix(n)
    raise ValueError(f"unknown transform {name!r}")


@lru_cache(maxsize=None)
def stack_matrices(name: str, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-power-of-two stack-transform matrices, zero-padded to n_max.

    Returns (fwd, inv), each of shape [log2(n_max)+1, n_max, n_max]; index
    log2(s) holds the size-s transform in the top-left block.
    """
    if n_max & (n_max - 1):
        raise ValueError(f"n_max must be a power of two, got {n_max}")
    depth = n_max.bit_length()  # sizes 1, 2, ..., n_max
    fwd = np.zeros((depth, n_max, n_max))
    inv = np.zeros((depth, n_max, n_max))
    for lvl in range(depth):
        s = 1 << lvl
        f, i = transform_pair(name if s > 1 else "id", s)
        fwd[lvl, :s, :s] = f
        inv[lvl, :s, :s] = i
    return fwd, inv


@lru_cache(maxsize=None)
def kaiser_window_1d(k: int, beta: float = 2.0) -> np.ndarray:
    """1-D Kaiser factor: kaiser_window(k) == outer(w, w). The fused
    engine's deferred-den finalize convolves with this factor separably."""
    return np.kaiser(k, beta)


@lru_cache(maxsize=None)
def kaiser_window(k: int, beta: float = 2.0) -> np.ndarray:
    """k x k Kaiser aggregation window, beta=2 (SURVEY.md §2.10.8)."""
    w = kaiser_window_1d(k, beta)
    return np.outer(w, w)
