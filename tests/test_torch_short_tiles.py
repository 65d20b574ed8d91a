"""The argument behind K6 batched's and K8's blocks sized to the row.

A row of n <= 4096 elements fills only the first W = ceil(n / 128) warps of
``csrc/scan.cuh``'s 1024-thread tile, so a block of W warps runs the
tile's float64 trees with the dropped warps' values (+0.0) left out: the
shuffle-down sum over each warp's lanes, then over the W warp sums (an
identity above W, and for W = 1 no second tree), and the Kogge-Stone
inclusive scan over lanes, then over warps.  Here those trees are written
as index arithmetic over lanes, at W warps, and held bit for bit to the
1024-thread tile's plain versions (``rs._tile_sums``, ``rs._cumsum_ref``);
the counts they yield (K1's arithmetic, the running max within a thread
and then across threads by the same scan) to
``systematic_counts_batched_ref``, and on dyadic weights to the TPU kernel
K6 batched replaces, ``_counts_packed_call``, in interpret mode.

This checks the argument, not the kernels: no CUDA code runs here.  The
kernels (``counts_short_rows``, and ``sweep_kernel``'s scan) are held bit
for bit to their plain versions on the card by ``chip_smoke.py``, phases
16 and 17.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.inference import resampling as rs
from composablestatespacemodels_torch.ops.scan_kernel import (
    systematic_counts_batched_ref)
from composablestatespacemodels_tpu.ops import scan_kernel as jsk

LANES, ITEMS = 32, 4
INT_MIN = torch.iinfo(torch.int32).min
_LANE = torch.arange(LANES)


def _down_tree(v, add):
    """``__shfl_down_sync`` tree over the last axis (32 lanes): lane l
    takes lane l + o (its own value past lane 31) for o = 16, ..., 1;
    returns lane 0."""
    for o in (16, 8, 4, 2, 1):
        src = torch.where(_LANE + o < LANES, _LANE + o, _LANE)
        v = add(v, v[..., src])
    return v[..., 0]


def _up_scan(v, add):
    """``__shfl_up_sync`` Kogge-Stone inclusive scan over the last axis:
    lane l >= o adds lane l - o, for o = 1, ..., 16."""
    for o in (1, 2, 4, 8, 16):
        v = torch.where(_LANE >= o, add(v, v[..., (_LANE - o).clamp(min=0)]),
                        v)
    return v


def _exclusive(incl, first):
    """Lane l takes lane l - 1 of the inclusive scan, lane 0 ``first``."""
    ex = incl[..., (_LANE - 1).clamp(min=0)]
    return torch.where(_LANE == 0, torch.full_like(ex, first), ex)


def _block_sum(v, w):
    """``block_sum`` of the threads' values ``v [..., 32 w]`` at w warps."""
    warp = _down_tree(v.unflatten(-1, (w, LANES)), torch.add)
    if w == 1:
        return warp[..., 0]
    second = torch.zeros(warp.shape[:-1] + (LANES,), dtype=v.dtype)
    second[..., :w] = warp
    return _down_tree(second, torch.add)


def _block_exclusive(v, w, add, identity):
    """``block_exclusive_sum`` (``block_exclusive_max``) at w warps."""
    incl = _up_scan(v.unflatten(-1, (w, LANES)), add)
    ex = _exclusive(incl, identity)
    if w == 1:
        return ex.flatten(-2)
    second = torch.full(incl.shape[:-2] + (LANES,), identity, dtype=v.dtype)
    second[..., :w] = incl[..., LANES - 1]
    offset = _exclusive(_up_scan(second, add), identity)[..., :w]
    return add(offset[..., None], ex).flatten(-2)


def _items(x, w):
    """``x [..., n]`` in float64, zero past n, as ``[..., 32 w, 4]``."""
    v = torch.zeros(x.shape[:-1] + (LANES * w * ITEMS,), dtype=torch.float64)
    v[..., :x.shape[-1]] = x.to(torch.float64)
    return v.unflatten(-1, (LANES * w, ITEMS))


def _thread_sums(items):
    tsum = torch.zeros(items.shape[:-1], dtype=torch.float64)
    for k in range(ITEMS):
        tsum = tsum + items[..., k]
    return tsum


def short_tile_sum(x, w):
    return _block_sum(_thread_sums(_items(x, w)), w)


def short_tile_cumsum(x, w):
    """The prefix of one short tile: the threads' exclusive scan (offset
    0.0), then each thread's items in order, rounded to float32."""
    items = _items(x, w)
    p = _block_exclusive(_thread_sums(items), w, torch.add, 0.0)
    out = torch.empty_like(items)
    for k in range(ITEMS):
        p = p + items[..., k]
        out[..., k] = p
    return out.flatten(-2)[..., :x.shape[-1]].to(torch.float32)


def short_tile_counts(wts, total, u, w):
    """K6 batched's counts on a short tile: K1's count per item, the
    running max within the thread, then across threads."""
    n = wts.shape[-1]
    cdf = short_tile_cumsum(wts / total[:, None], w)
    c = torch.clamp(torch.ceil(n * cdf - u[:, None]), 0, n).to(torch.int32)
    c[:, -1] = n
    items = torch.full((wts.shape[0], LANES * w * ITEMS), INT_MIN,
                       dtype=torch.int32)
    items[:, :n] = c
    items = torch.cummax(items.unflatten(-1, (LANES * w, ITEMS)), -1).values
    ex = _block_exclusive(items[..., -1], w, torch.maximum, INT_MIN)
    return torch.maximum(items, ex[..., None]).flatten(-2)[:, :n]


def _rows(kind, n, rng):
    """Three rows of float32 weights: with zeros, with runs of tiny values,
    or with one dominant weight."""
    rows = []
    for _ in range(3):
        w = np.exp(0.5 * rng.normal(size=n))
        if kind == "zeros":
            w[rng.random(n) < 0.3] = 0.0
        elif kind == "tiny":
            for start in rng.integers(0, n, size=max(1, n // 50)):
                w[start:start + 17] = 10.0 ** rng.uniform(-38, -30)
            w[rng.random(n) < 0.1] = 0.0
        else:
            w *= 1e-9
            w[rng.integers(0, n)] = 1.0
        rows.append(w)
    return torch.from_numpy(np.stack(rows).astype(np.float32))


@pytest.mark.parametrize("kind", ["zeros", "tiny", "dominant"])
@pytest.mark.parametrize("n", [1, 5, 100, 128, 129, 1000, 1024, 4096])
def test_short_tile_trees_match_the_tile(n, kind):
    rng = np.random.default_rng(1000 * n + len(kind))
    w = -(-n // (LANES * ITEMS))
    wts = _rows(kind, n, rng)
    total = wts.sum(-1)
    x = wts / total[:, None]
    tile_sum = rs._tile_sums(rs._tile_pad(x))[:, 0]
    assert torch.equal(short_tile_sum(x, w), tile_sum)
    assert torch.equal(short_tile_cumsum(x, w), rs._cumsum_ref(x))
    u = torch.from_numpy(rng.random(3).astype(np.float32))
    assert torch.equal(short_tile_counts(wts, total, u, w),
                       systematic_counts_batched_ref(wts, total, u))


@pytest.mark.parametrize("n", [1, 129])
def test_short_tile_counts_match_jax_packed_kernel(n):
    """Dyadic weights (integers over 2^15) make every prefix exact in any
    order, so the short tile's counts, the plain version's and the JAX
    kernel's agree bit for bit."""
    rng = np.random.default_rng(n)
    k = rng.integers(0, 8, (3, n)).astype(np.int64)
    k[:, -1] += 2 ** 15 - k.sum(-1)
    wts = torch.from_numpy(k.astype(np.float32))
    total = torch.full((3,), 2.0 ** 15)
    u = torch.tensor([0.0, 0.5, 0.999])
    got = short_tile_counts(wts, total, u, -(-n // (LANES * ITEMS)))
    assert torch.equal(got, systematic_counts_batched_ref(wts, total, u))
    rows_per = jsk._eff_block_rows(n, 256)
    x = np.zeros((3, rows_per * 128), np.float32)
    x[:, :n] = wts.numpy()
    scal = np.zeros((3, 8, 128), np.float32)
    scal[:, 0, :] = total.numpy()[:, None]
    scal[:, 1, :] = u.numpy()[:, None]
    last = ((n - 1) // (128 * rows_per), ((n - 1) % (128 * rows_per)) // 128,
            (n - 1) % 128)
    packed = jsk._counts_packed_call(
        n, last, rows_per, jnp.asarray(scal),
        jnp.asarray(x.reshape(3, rows_per, 128)), interpret=True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(packed).reshape(3, -1)[:, :n])
