"""The row-gather kernel's decomposition (csrc/gather.cu), emulated in numpy.

`gather_plan` is the Python copy of the kernel's launch plan. The emulation
walks every block of the plan as the kernel does (shared row offsets,
scalar head and tail, 16-byte vectors GATHER_UNROLL per thread and pass)
over an output whose base sits at each of the four word offsets of a
16-byte line, and checks that every output word is written exactly once,
that every vector store is 16-byte aligned, and that the result equals
`index_select` (the plain version)."""

import numpy as np
import pytest
import torch

from lfbm5d_torch.kernels.gather import (
    GATHER_MAX_ROWS, GATHER_MAX_THREADS, GATHER_MIN_GRID, GATHER_UNROLL,
    gather_plan, gather_rows_plain,
)

torch.set_num_threads(2)


def emulate(table, idx, base_word=0):
    """The kernel's writes of out = table[idx] into a flat buffer whose
    first output word sits at word offset base_word of a 16-byte line:
    (out [S, W], times each word was written, vector windows' word
    addresses)."""
    s, w = idx.shape[0], table.shape[1]
    r_tile, threads, grid = gather_plan(s, w)
    flat = table.reshape(-1)
    out = np.zeros(base_word + s * w, table.dtype)
    count = np.zeros(base_word + s * w, np.int64)
    windows = []
    for b in range(grid):
        s0 = b * r_tile
        rows = min(r_tile, s - s0)
        base = idx[s0:s0 + rows].astype(np.int64) * w  # shared row offsets
        dst = base_word + s0 * w  # word address of the tile's run
        n = rows * w
        head = min(n, (4 - dst % 4) % 4)
        nvec = (n - head) // 4
        tail = head + 4 * nvec
        for t in range(6):  # the scalar stores
            p = t if t < 3 else tail + t - 3
            if (p < head) if t < 3 else (p < n):
                r = p // w
                out[dst + p] = flat[base[r] + p - r * w]
                count[dst + p] += 1
        for tid in range(threads):
            for v0 in range(tid, nvec, threads * GATHER_UNROLL):
                for u in range(GATHER_UNROLL):
                    v = v0 + u * threads
                    if v >= nvec:
                        continue
                    p = head + 4 * v
                    r, c = divmod(p, w)
                    for j in range(4):
                        out[dst + p + j] = flat[base[r] + c]
                        count[dst + p + j] += 1
                        c += 1
                        if c == w:
                            c, r = 0, r + 1
                    windows.append(dst + p)
    return (out[base_word:].reshape(s, w), count[base_word:],
            np.asarray(windows, np.int64))


CASES = [(1, 1), (1, 7), (5, 1), (13, 7), (300, 81), (1031, 81),
         (77, 289), (529, 289), (2000, 7), (4099, 1)]


@pytest.mark.parametrize("base_word", [0, 1, 2, 3])
@pytest.mark.parametrize("s,w", CASES)
def test_decomposition_writes_each_word_once(s, w, base_word):
    rng = np.random.default_rng(s * 1000 + w)
    v = 97
    table = rng.integers(-2**31, 2**31 - 1, (v, w), dtype=np.int64).astype(
        np.int32)
    idx = rng.integers(0, v, (s,)).astype(np.int32)
    out, count, windows = emulate(table, idx, base_word)
    assert (count == 1).all()
    assert (windows % 4 == 0).all()
    want = gather_rows_plain(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(out, want.numpy())
    if base_word == 0:  # an aligned output needs no scalar head
        r_tile = gather_plan(s, w)[0]
        assert len(windows) == sum(
            min(r_tile, s - s0) * w // 4 for s0 in range(0, s, r_tile))


def test_decomposition_float32_bits():
    """float32 tables move as 32-bit words: NaN payloads, -0.0 and
    denormals come out bit for bit."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (40, 7), dtype=np.uint64).astype(np.uint32)
    words[0, :3] = [0x7FC01234, 0x80000000, 0x00000001]
    table = words.view(np.float32)
    idx = np.asarray([0, 3, 0, 39, 5], np.int32)
    out, count, _ = emulate(table, idx, 1)
    assert (count == 1).all()
    want = gather_rows_plain(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("s", [0, 1, 3, 264, 1055, 1056, 34000, 10**6])
@pytest.mark.parametrize("w", [1, 2, 7, 81, 289, 1024, 4097, 100000])
def test_plan_limits(s, w):
    r, threads, grid = gather_plan(s, w)
    assert r % 4 == 0 and 4 <= r <= GATHER_MAX_ROWS
    assert threads % 32 == 0 and 32 <= threads <= GATHER_MAX_THREADS
    assert grid * r >= s > (grid - 1) * r or (s == 0 and grid == 0)
    # a tile's vectors take at most one pass of the block where the tile's
    # word budget allows
    if threads < GATHER_MAX_THREADS:
        assert -(-(r * w) // 4) <= threads * GATHER_UNROLL
    # R is the tile's word budget, or smaller only where R + 4 would give
    # at most GATHER_MIN_GRID blocks
    budget = min(max(4096 // w - (4096 // w) % 4, 4), GATHER_MAX_ROWS)
    assert r <= budget
    if r < budget:
        assert -(-s // (r + 4)) <= GATHER_MIN_GRID
