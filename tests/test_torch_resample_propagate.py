"""The plain version of kernel K2 + K3 (fused resample + propagate +
log-weights) against the JAX Pallas kernel, a numpy formula and the
Philox4x32-10 reference.

With s = 0 the JAX kernel in interpret mode is deterministic (its in-kernel
noise is a constant there), so the port and JAX compare value by value:
state rows within rtol 1e-6, the log-weights within rtol 2e-5 / atol 1e-5
(exp/lgamma ulps), as ``tests/test_pallas_resample.py`` holds the JAX
kernel against XLA.  With s != 0 the noise is the port's own Philox
stream, checked against its published known-answer vectors and for its
normal moments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

from composablestatespacemodels_torch.inference.resampling import (
    systematic_counts)
from composablestatespacemodels_torch.models import observation as tobs
from composablestatespacemodels_torch.ops.resample_kernel import (
    philox4x32_10, philox_normals, resample_propagate, resample_propagate_ref)
from composablestatespacemodels_tpu.models import observation as jobs
from composablestatespacemodels_tpu.ops.resample_kernel import (
    sorted_gather_resample_propagate_t)

N, D = 2048, 7
FAMILIES = [("poisson", 3.0, 1.0), ("gaussian", 0.7, 0.4)]


def _inputs(seed=0, s=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(D, N)) * 0.3).astype(np.float32)
    w = (rng.uniform(size=N) + 0.01).astype(np.float32)
    counts = systematic_counts(torch.from_numpy(w), float(rng.uniform()))
    a = np.full(D, 0.9, np.float32)
    b = np.full(D, 0.05, np.float32)
    design = np.linspace(0.5, 1.5, D).astype(np.float32)
    coef = np.stack([a, b, np.full(D, s, np.float32), design], axis=1)
    return x, counts, coef


def _family(name, y, scale):
    jf, tf = ((jobs.Poisson(), tobs.Poisson()) if name == "poisson"
              else (jobs.Gaussian(), tobs.Gaussian()))
    make, fid = tf.kernel_log_density()
    consts = torch.zeros(tobs.KERNEL_CONSTS)
    c = make(torch.tensor(y), torch.tensor(scale))
    consts[:c.shape[-1]] = c
    return jf, fid, consts


@pytest.mark.parametrize("name,y,scale", FAMILIES)
def test_zero_noise_matches_jax_kernel(name, y, scale):
    x, counts, coef = _inputs(1)
    jf, fid, consts = _family(name, y, scale)
    yt, lw = resample_propagate_ref(torch.from_numpy(x), counts,
                                    torch.from_numpy(coef), consts,
                                    torch.tensor(5, dtype=torch.int32), fid)
    # JAX: d padded to 8, the log-weights in the reserved row 7
    x8 = np.concatenate([x, np.zeros((1, N), np.float32)])
    coef8 = np.concatenate([coef, np.zeros((1, 4), np.float32)])
    j_make, _ = jf.kernel_log_density()
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(sorted_gather_resample_propagate_t(
            jnp.asarray(x8), jnp.asarray(counts.numpy()), jnp.asarray(coef8),
            jnp.array([5], jnp.int32), block=1024, weight_family=jf,
            weight_consts=j_make(jnp.float32(y), jnp.float32(scale)),
            weight_row=D))
    np.testing.assert_allclose(yt.numpy(), out[:D], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lw.numpy(), out[D], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name,y,scale", FAMILIES)
def test_noisy_matches_numpy_formula(name, y, scale):
    x, counts, coef = _inputs(2, s=0.3)
    jf, fid, consts = _family(name, y, scale)
    seed = torch.tensor(-123456789, dtype=torch.int32)
    yt, lw = resample_propagate(torch.from_numpy(x), counts,
                                torch.from_numpy(coef), consts, seed, fid)
    anc = np.searchsorted(counts.numpy(), np.arange(N), side="right")
    z = philox_normals(seed, D, N).numpy().astype(np.float64)
    a, b, s, design = (coef[:, k, None].astype(np.float64) for k in range(4))
    want = a * x[:, anc] + b + s * z
    np.testing.assert_allclose(yt.numpy(), want, rtol=1e-5, atol=1e-6)
    gamma = (design * want).sum(axis=0)
    want_lw = np.asarray(jf.log_density(jnp.asarray(gamma, jnp.float32),
                                        jnp.float32(y), jnp.float32(scale)))
    np.testing.assert_allclose(lw.numpy(), want_lw, rtol=2e-5, atol=1e-5)


# Random123 known-answer vectors for philox4x32_10 (ctr, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(tuple(torch.tensor(c) for c in ctr),
                        tuple(torch.tensor(k) for k in key))
    assert tuple(int(g) for g in got) == want


def test_philox_stream_depends_only_on_seed_and_column():
    s1, s2 = torch.tensor(77, dtype=torch.int32), torch.tensor(78,
                                                               dtype=torch.int32)
    a = philox_normals(s1, D, 4096)
    np.testing.assert_array_equal(a.numpy(), philox_normals(s1, D, 4096).numpy())
    # a column's normals do not depend on how many columns are drawn
    np.testing.assert_array_equal(a[:, :100].numpy(),
                                  philox_normals(s1, D, 100).numpy())
    assert not torch.equal(a, philox_normals(s2, D, 4096))


def test_philox_normals_moments():
    z = philox_normals(torch.tensor(2026, dtype=torch.int32), D, 1 << 16)
    z = z.numpy().astype(np.float64)
    n = z.shape[1]
    assert np.abs(z.mean(axis=1)).max() < 5 / np.sqrt(n)
    assert np.abs(z.var(axis=1) - 1).max() < 5 * np.sqrt(2 / n)
    corr = np.corrcoef(z)
    assert np.abs(corr - np.eye(D)).max() < 5 / np.sqrt(n)
    for row in z:
        assert stats.kstest(row, "norm").pvalue > 1e-3


def test_wrapper_uses_plain_version_only_on_cpu():
    x, counts, coef = _inputs(3, s=0.2)
    _, fid, consts = _family("poisson", 2.0, 1.0)
    seed = torch.tensor(9, dtype=torch.int32)
    args = (torch.from_numpy(x), counts, torch.from_numpy(coef), consts, seed)
    for g, w in zip(resample_propagate(*args, fid),
                    resample_propagate_ref(*args, fid)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    meta = tuple(t.to("meta") for t in args)
    with pytest.raises(ValueError, match="no K2 kernel"):
        resample_propagate(*meta, fid)
