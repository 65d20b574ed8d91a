"""The plain version of kernel K5 (+ K3: the standalone exact propagate
with optional log-weights) against the JAX Pallas kernel
``propagate_weights_t`` in interpret mode.

The JAX kernel runs under ``pltpu.force_tpu_interpret_mode()``, as its
own tests run it (its in-kernel PRNG has no plain ``interpret=True``
lowering).  Interpret mode's in-kernel random bits are constant, so the
two packages compare value by value only with zero noise (s = 0).  The
port rounds ``a * x`` and ``+ b`` separately, as its CUDA kernel does (the
card holds the two bit for bit); XLA's CPU backend contracts them into one
fused multiply-add.  So each state row is held bit for bit to its own
formula on the same inputs -- the port to ``fl(fl(a*x) + b)``, the JAX
kernel to ``fl(a*x + b)`` -- and the log-weights within rtol 2e-5 /
atol 1e-5 (the JAX kernel sums the design contraction in its own order,
and exp/lgamma differ by ulps).
With noise the port draws its own Philox normals, checked for their
moments here and value by value against the kernel on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composablestatespacemodels_torch.models import observation as tobs
from composablestatespacemodels_torch.ops.resample_kernel import (
    propagate_weights_t, propagate_weights_t_ref, resample_propagate_ref,
    sorted_gather_resample_t_ref)
from composablestatespacemodels_torch.inference.resampling import (
    systematic_counts)
from composablestatespacemodels_tpu.models import observation as jobs
from composablestatespacemodels_tpu.ops.resample_kernel import (
    propagate_weights_t as jax_propagate_weights_t)

N, D = 2048, 7
FAMILIES = [("poisson", 3.0, 1.0), ("gaussian", 0.7, 0.4)]
SEED = torch.tensor(3, dtype=torch.int32)


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(D, N)) * 0.3).astype(np.float32)
    a = np.linspace(0.2, 1.0, D).astype(np.float32)
    b = np.linspace(-0.5, 0.5, D).astype(np.float32)
    design = np.linspace(0.5, 1.5, D).astype(np.float32)
    coef = np.stack([a, b, np.full(D, s, np.float32), design], axis=1)
    return x, coef


def _family(name, y, scale):
    jf, tf = ((jobs.Poisson(), tobs.Poisson()) if name == "poisson"
              else (jobs.Gaussian(), tobs.Gaussian()))
    make, fid = tf.kernel_log_density()
    consts = torch.zeros(tobs.KERNEL_CONSTS)
    c = make(torch.tensor(y), torch.tensor(scale))
    consts[:c.shape[-1]] = c
    return jf, fid, consts


def _fma(coef, x):
    """``a * x + b`` rounded once (float64 holds the product exactly)."""
    return (coef[:, 0:1].astype(np.float64) * x
            + coef[:, 1:2]).astype(np.float32)


def test_zero_noise_unweighted_matches_jax_kernel():
    x, coef = _inputs(0, 0.0)
    y, logw = propagate_weights_t_ref(torch.from_numpy(x),
                                      torch.from_numpy(coef[:, :3]), None,
                                      SEED, None)
    assert logw is None
    # JAX: d padded to 8 (its DMA alignment), zero coefficients there
    x8 = np.concatenate([x, np.zeros((1, N), np.float32)])
    coef8 = np.concatenate([coef[:, :3], np.zeros((1, 3), np.float32)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_propagate_weights_t(
            jnp.asarray(x8), jnp.asarray(coef8), jnp.array([3], jnp.int32),
            block=1024))[:D]
    np.testing.assert_array_equal(y.numpy(),
                                  coef[:, 0:1] * x + coef[:, 1:2])
    np.testing.assert_array_equal(want, _fma(coef, x))


@pytest.mark.parametrize("name,y,scale", FAMILIES)
def test_zero_noise_weighted_matches_jax_kernel(name, y, scale):
    x, coef = _inputs(1, 0.0)
    jf, fid, consts = _family(name, y, scale)
    yt, lw = propagate_weights_t_ref(torch.from_numpy(x),
                                     torch.from_numpy(coef), consts, SEED,
                                     fid)
    # JAX: the log-weights go into the reserved padding row 7
    x8 = np.concatenate([x, np.zeros((1, N), np.float32)])
    coef8 = np.concatenate([coef, np.zeros((1, 4), np.float32)])
    j_make, _ = jf.kernel_log_density()
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jax_propagate_weights_t(
            jnp.asarray(x8), jnp.asarray(coef8), jnp.array([3], jnp.int32),
            block=1024, weight_family=jf,
            weight_consts=j_make(jnp.float32(y), jnp.float32(scale)),
            weight_row=D))
    np.testing.assert_array_equal(yt.numpy(),
                                  coef[:, 0:1] * x + coef[:, 1:2])
    np.testing.assert_array_equal(out[:D], _fma(coef, x))
    np.testing.assert_allclose(lw.numpy(), out[D], rtol=2e-5, atol=1e-5)


def test_noise_is_standard_normal():
    """y = a x + b + s z with a = 0, b = 0, s = 1 exposes the normals:
    mean 0 and variance 1 per row within 5 standard errors."""
    n = 1 << 15
    coef = torch.zeros(D, 3)
    coef[:, 2] = 1.0
    z, _ = propagate_weights_t_ref(torch.zeros(D, n), coef, None,
                                   torch.tensor(-77, dtype=torch.int32), None)
    z = z.numpy().astype(np.float64)
    assert np.abs(z.mean(axis=1)).max() < 5 / np.sqrt(n)
    assert np.abs(z.var(axis=1) - 1).max() < 5 * np.sqrt(2 / n)


@pytest.mark.parametrize("name,y,scale", FAMILIES)
def test_k2_is_k4_then_k5(name, y, scale):
    """K2's plain version is the plain gather followed by the plain
    propagate, noise included (K2 and K5 share the Philox counter)."""
    x, coef = _inputs(2, 0.3)
    _, fid, consts = _family(name, y, scale)
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.uniform(size=N) + 0.01, dtype=torch.float32)
    counts = systematic_counts(w, torch.tensor(0.4))
    xt, ct_ = torch.from_numpy(x), torch.from_numpy(coef)
    y2, l2 = resample_propagate_ref(xt, counts, ct_, consts, SEED, fid)
    y5, l5 = propagate_weights_t(sorted_gather_resample_t_ref(xt, counts),
                                 ct_, consts, SEED, fid)
    np.testing.assert_array_equal(y2.numpy(), y5.numpy())
    np.testing.assert_array_equal(l2.numpy(), l5.numpy())


def test_wrapper_uses_plain_version_only_on_cpu():
    x, coef = _inputs(3, 0.2)
    _, fid, consts = _family("poisson", 2.0, 1.0)
    args = (torch.from_numpy(x), torch.from_numpy(coef), consts, SEED)
    for g, w in zip(propagate_weights_t(*args, fid),
                    propagate_weights_t_ref(*args, fid)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    meta = tuple(t.to("meta") for t in args)
    with pytest.raises(ValueError, match="no K5 kernel"):
        propagate_weights_t(*meta, fid)
