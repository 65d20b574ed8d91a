"""K2's merge-path ancestors, replayed in plain PyTorch.

``ops/resample_kernel.py::merge_path_ancestors_ref`` repeats the
arithmetic of ``csrc/ancestor.cuh::merge_path_ancestors``: each block owns
a fixed range of the 2N merged positions of particle boundaries and output
slots, its split found by the device's 32-probe search
(``merge_split_ref``), and each thread walks its positions within the
block's bounds.  On every kind of counts -- the weight regimes, one
particle owning every slot, two spikes with zero-offspring particles
between them, random counts -- and at the kernel's block shape and a
small one, the expansion equals ``_ancestors_from_counts``, and each
block's counts plus its slots fill exactly its range.
"""

import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.inference.resampling import (
    _ancestors_from_counts, systematic_counts)
from composablestatespacemodels_torch.ops.resample_kernel import (
    MERGE_ITEMS, MERGE_THREADS, merge_path_ancestors_ref, merge_split_ref)

# (threads, items): the kernel's block, and small ones with many blocks
SHAPES = [(MERGE_THREADS, MERGE_ITEMS), (4, 2), (3, 5)]
SIZES = [1, 2, 100, 2047, 2049, 3 * 2048 + 5, 20000]


def _counts(kind: str, n: int) -> torch.Tensor:
    rng = np.random.default_rng(n)
    if kind in ("uniform", "mild", "heavy", "degenerate"):
        z = rng.normal(size=n)
        w = {"uniform": np.ones(n), "mild": np.exp(0.5 * z),
             "heavy": np.exp(z) ** 4}.get(kind)
        if w is None:
            w = np.full(n, 1e-12)
            w[n // 3] = 1.0
        w = torch.from_numpy((w / w.sum()).astype(np.float32))
        return systematic_counts(w, float(rng.uniform()))
    c = np.zeros(n, np.int64)
    if kind == "first_owns_all":
        c[:] = n
    elif kind == "last_owns_all":
        c[-1] = n
    elif kind == "spikes":              # particles 0 and n-1 own every slot
        c[:] = n // 2
        c[-1] = n
    elif kind == "alternating":         # offspring 2, 0, 2, 0, ...
        c = np.minimum(2 * (np.arange(n) // 2 + 1), n)
        c[-1] = n
    else:                               # random: sorted draws in [0, n]
        c = np.sort(rng.integers(0, n + 1, n))
        c[-1] = n
    return torch.from_numpy(c.astype(np.int32))


KINDS = ["uniform", "mild", "heavy", "degenerate", "first_owns_all",
         "last_owns_all", "spikes", "alternating", "random"]


@pytest.mark.parametrize("threads,items", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_expansion_equals_ancestors(kind, threads, items):
    for n in SIZES:
        counts = _counts(kind, n)
        want = _ancestors_from_counts(counts, n).long()
        got = merge_path_ancestors_ref(counts, threads, items)
        assert torch.equal(got, want), (kind, n)


@pytest.mark.parametrize("kind", KINDS)
def test_split_is_the_corank_and_blocks_fill_their_range(kind):
    """The 32-probe search finds the co-rank ``#{i : counts[i] + i < d}``
    at every merged position, and a block's particles and slots number
    exactly its range, so no block stages more than a tile of counts."""
    n = 3 * 2048 + 5
    counts = _counts(kind, n)
    d = torch.arange(2 * n + 1)
    key = counts.long().clamp(0, n) + torch.arange(n)
    split = merge_split_ref(counts, d)
    assert torch.equal(split, torch.searchsorted(key, d))
    tile = MERGE_THREADS * MERGE_ITEMS
    edges = torch.cat([torch.arange(0, 2 * n, tile), torch.tensor([2 * n])])
    i = merge_split_ref(counts, edges)
    particles, slots = torch.diff(i), torch.diff(edges - i)
    assert torch.equal(particles + slots, torch.diff(edges))
    assert bool(((particles >= 0) & (slots >= 0)).all())
    assert int(slots.sum()) == n and int(particles.sum()) == n


def test_counts_ending_below_n_take_the_last_particle():
    """Slots past ``counts[-1]`` have no particle; like ``upper_bound``'s
    clamp they take particle N - 1."""
    n = 5000
    c = np.sort(np.random.default_rng(3).integers(0, n - 700, n))
    counts = torch.from_numpy(c.astype(np.int32))
    j = torch.arange(n)
    want = torch.searchsorted(counts.long(), j, right=True).clamp(max=n - 1)
    for threads, items in SHAPES:
        assert torch.equal(merge_path_ancestors_ref(counts, threads, items),
                           want)
