"""The plain version of kernel K4 (the resampling gather on the ``[d, N]``
cloud) against the JAX Pallas kernel ``sorted_gather_resample_t`` in
interpret mode, on identical counts.

A gather has no rounding, so the two agree bit for bit.  The JAX kernel
takes ``d`` padded to a multiple of 8 (as its filter pads it); the port
takes any ``d``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.inference import resampling as trs
from composablestatespacemodels_torch.ops.resample_kernel import (
    merge_path_ancestors_ref, sorted_gather_resample,
    sorted_gather_resample_t, sorted_gather_resample_t_ref)
from composablestatespacemodels_tpu.ops import resample_kernel as jrk

N = 2048


def _counts(regime, n, seed):
    rng = np.random.default_rng(seed)
    if regime == "random":
        w = rng.uniform(size=n) + 0.01
    elif regime == "heavy":
        w = np.exp(rng.normal(size=n)) ** 4
    elif regime == "spike":
        w = np.full(n, 1e-12)
        w[n // 3] = 1.0
    elif regime == "two_spikes":
        w = np.zeros(n)
        w[1], w[n - 48] = 0.5, 0.5
    else:  # last: every slot from the last particle
        w = np.zeros(n)
        w[-1] = 1.0
    w = torch.tensor(w / w.sum(), dtype=torch.float32)
    return trs.systematic_counts(w, torch.tensor(np.float32(rng.uniform())))


def _jax_gather(x, counts, block):
    """The JAX K4 in interpret mode, ``d`` padded to a multiple of 8 and N
    to one of ``block`` (padded particles own the padded slots, so the
    first N columns are the gather of the unpadded cloud)."""
    d, n = x.shape
    m = -(-n // block) * block
    x8 = np.zeros((d + (-d) % 8, m), np.float32)
    x8[:d, :n] = x
    c = np.full(m, m, np.int32)
    c[:n] = counts.numpy()
    out = jrk.sorted_gather_resample_t(jnp.asarray(x8), jnp.asarray(c),
                                       block=block, interpret=True)
    return np.asarray(out)[:d, :n]


@pytest.mark.parametrize("regime", ["random", "heavy", "spike", "two_spikes",
                                    "last"])
def test_matches_jax_kernel_bitwise(regime):
    counts = _counts(regime, N, 7)
    x = np.random.default_rng(1).normal(size=(5, N)).astype(np.float32)
    got = sorted_gather_resample_t_ref(torch.from_numpy(x), counts).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _jax_gather(x, counts, 1024).view(np.int32))


@pytest.mark.parametrize("n,d", [(N, 5), (2 ** 13 + 5, 1)])
@pytest.mark.parametrize("regime", ["random", "heavy", "spike", "two_spikes",
                                    "last"])
def test_merge_path_gather_matches_jax_kernel_bitwise(regime, n, d):
    """The gather by K2's and K4's merge-path ancestors, as the CUDA kernel
    expands them (``merge_path_ancestors_ref``), against the JAX K4 bit for
    bit, also at an N that is no multiple of the merge tile and at d = 1."""
    counts = _counts(regime, n, 9)
    x = np.random.default_rng(d).normal(size=(d, n)).astype(np.float32)
    got = x[:, merge_path_ancestors_ref(counts).numpy()]
    np.testing.assert_array_equal(got.view(np.int32),
                                  _jax_gather(x, counts, 1024).view(np.int32))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_odd_widths(d):
    counts = _counts("heavy", N, d)
    x = np.random.default_rng(d).normal(size=(d, N)).astype(np.float32)
    got = sorted_gather_resample_t(torch.from_numpy(x), counts).numpy()
    np.testing.assert_array_equal(got, _jax_gather(x, counts, 1024))


def test_row_wrapper_matches_jax():
    counts = _counts("random", N, 3)
    x = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    got = sorted_gather_resample(torch.from_numpy(x), counts)
    want = np.asarray(jrk.sorted_gather_resample(
        jnp.asarray(x), jnp.asarray(counts.numpy()), block=1024,
        interpret=True))
    assert got.shape == (N, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), x[trs._ancestors_from_counts(counts, N).numpy()])


def test_wrapper_uses_plain_version_only_on_cpu():
    counts = _counts("random", 512, 4)
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        sorted_gather_resample_t(x, counts).numpy(),
        sorted_gather_resample_t_ref(x, counts).numpy())
    with pytest.raises(ValueError, match="no K4 kernel"):
        sorted_gather_resample_t(x.to("meta"), counts.to("meta"))
