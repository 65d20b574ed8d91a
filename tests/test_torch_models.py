"""Parity of composablestatespacemodels_torch's model layer with the JAX
package on identical numpy inputs: bijectors, trees, parameters,
transition coefficients, initial moments, design vectors, f_t and the
Gaussian/Poisson densities and kernel constants.

Tolerance: rtol 1e-6 (1e-5 where lgamma or exp is involved: XLA's and
torch's CPU libm differ by ulps), with atol 1e-6 for entries near zero
(logit near 1/2, lgamma near 1 and 2, cos/sin of the seasonal design:
there a relative bound is meaningless).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.models import bijectors as tb
from composablestatespacemodels_torch.models import observation as tobs
from composablestatespacemodels_tpu.models import bijectors as jb
from composablestatespacemodels_tpu.models import observation as jobs

from _torch_parity import both, jax_params_to_numpy

RNG = np.random.default_rng(20261016)
DTS = np.array([0.0, 0.1, 0.5, 1.0, 2.5, 7.0], np.float32)
TS = np.array([0.0, 0.3, 1.0, 5.0, 11.7, 24.0, 100.0], np.float32)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,x", [
    ("logit", RNG.uniform(0.01, 0.99, 64).astype(np.float32)),
    ("logistic", RNG.normal(0, 6, 64).astype(np.float32)),
    ("to_log", RNG.uniform(0.01, 50, 64).astype(np.float32)),
    ("from_log", RNG.normal(0, 3, 64).astype(np.float32)),
    ("to_logit", RNG.uniform(0.01, 0.99, 64).astype(np.float32)),
])
def test_bijectors(name, x):
    _close(getattr(tb, name)(torch.from_numpy(x)),
           getattr(jb, name)(jnp.asarray(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["flagship", "oracle", "seasonal_linear"])
def test_tree_and_params_from_numpy(model):
    jm, jp, tm, tp = both(model)
    assert tp.structure() == jp.structure() == tm.structure()
    jleaves, tleaves = jp.flatten(), tp.flatten()
    assert len(jleaves) == len(tleaves)
    for jn, tn in zip(jleaves, tleaves):
        assert (jn.scale is None) == (tn.scale is None)
        if jn.scale is not None:
            np.testing.assert_array_equal(tn.scale.numpy(), np.asarray(jn.scale))
        assert type(tn.sde).__name__ == type(jn.sde).__name__
        for f in jn.sde.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(tn.sde, f).numpy(),
                                          np.asarray(getattr(jn.sde, f)))
    tm.validate_params(tp)
    # a parameter tree of the wrong shape is refused, as in JAX
    with pytest.raises(TypeError):
        tm.validate_params(tp.flatten()[0] if model != "oracle"
                           else ct.branch(tp, tp))


@pytest.mark.parametrize("ctor,args", [
    ("ou_params", (0.2, 0.3, 0.25, -0.4, 0.7)),
    ("brownian_params", (0.1, 2.0, 0.4)),
    ("gen_brownian_params", (0.1, 2.0, -0.3, 0.4)),
])
def test_param_constructors(ctor, args):
    jp = getattr(cj.models, ctor)(*args)
    tp = getattr(ct.models, ctor)(*args)
    for f in jp.__dataclass_fields__:
        _close(getattr(tp, f), getattr(jp, f))
    back = ct.params_from_numpy(jax_params_to_numpy(cj.parameters(None, jp)))
    for f in jp.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(back.value.sde, f).numpy(),
                                      np.asarray(getattr(jp, f)))


@pytest.mark.parametrize("model", ["flagship", "oracle", "seasonal_linear"])
def test_transition_coeffs_vectorised_over_steps(model):
    jm, jp, tm, tp = both(model)
    got = tm.sde.transition_coeffs(tm.sde_params(tp), torch.from_numpy(DTS))
    for k, dt in enumerate(DTS):
        want = jm.sde.transition_coeffs(jm.sde_params(jp), jnp.float32(dt))
        for g, w in zip(got, want):
            _close(g[k], w, rtol=1e-5, atol=1e-7)
    # scalar dt gives [d]
    a, _, _ = tm.sde.transition_coeffs(tm.sde_params(tp), 1.0)
    assert a.shape == (tm.dim,)


@pytest.mark.parametrize("model", ["flagship", "oracle", "seasonal_linear"])
def test_initial_moments(model):
    jm, jp, tm, tp = both(model)
    for g, w in zip(tm.sde.initial_moments(tm.sde_params(tp)),
                    jm.sde.initial_moments(jm.sde_params(jp))):
        _close(g, w, rtol=1e-6)


@pytest.mark.parametrize("model", ["flagship", "oracle", "seasonal_linear"])
def test_design_vector(model):
    jm, _, tm, _ = both(model)
    got = tm.design_vector(torch.from_numpy(TS))
    assert got.shape == (len(TS), tm.dim)
    for k, t in enumerate(TS):
        _close(got[k], jm.design_vector(jnp.float32(t)), rtol=1e-6,
               atol=1e-6)


@pytest.mark.parametrize("model", ["flagship", "oracle", "seasonal_linear"])
def test_f_t(model):
    jm, _, tm, _ = both(model)
    x = RNG.normal(0, 1, (tm.dim, 257)).astype(np.float32)
    for t in (0.0, 5.0, 11.7):
        _close(tm.f_t(torch.from_numpy(x), t),
               jm.f_t(jnp.asarray(x), jnp.float32(t)), rtol=1e-5, atol=1e-6)


FAMILIES = [
    ("poisson", 3.0, 1.0), ("poisson", 0.0, 1.0), ("poisson", 17.0, 1.0),
    ("gaussian", 0.7, 0.4), ("gaussian", -2.3, 1.7),
]


def _families(name):
    if name == "poisson":
        return jobs.Poisson(), tobs.Poisson()
    return jobs.Gaussian(), tobs.Gaussian()


@pytest.mark.parametrize("name,y,scale", FAMILIES)
def test_log_density_and_kernel_hook(name, y, scale):
    jf, tf = _families(name)
    gamma = RNG.normal(0.5, 1.0, 513).astype(np.float32)
    tg = torch.from_numpy(gamma)
    want = jf.log_density(jnp.asarray(gamma), jnp.float32(y),
                          jnp.float32(scale))
    _close(tf.log_density(tg, torch.tensor(y), torch.tensor(scale)), want,
           rtol=1e-5)

    j_make, j_fn = jf.kernel_log_density()
    t_make, fid = tf.kernel_log_density()
    jc = j_make(jnp.float32(y), jnp.float32(scale))
    tc = t_make(torch.tensor(y), torch.tensor(scale))
    _close(tc, jc, rtol=1e-5, atol=1e-6)  # XLA's gammaln(1) is 4.8e-7
    # the torch twin of the K3 device function computes the log-density
    _close(tobs.kernel_fn(fid)(tg, tc), j_fn(jnp.asarray(gamma), jc),
           rtol=1e-5, atol=1e-6)
    _close(tobs.kernel_fn(fid)(tg, tc), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["poisson", "gaussian"])
def test_make_consts_vectorised_over_steps(name):
    _, tf = _families(name)
    make, _ = tf.kernel_log_density()
    ys = torch.tensor([0.0, 1.0, 4.0, 9.0])
    batched = make(ys, torch.tensor(0.8))
    for k in range(len(ys)):
        np.testing.assert_array_equal(batched[k].numpy(),
                                      make(ys[k], torch.tensor(0.8)).numpy())


def test_composition_is_left_biased():
    tm = ct.poisson(ct.ou_process(1)) + ct.seasonal(24, 3, ct.ou_process(6))
    assert isinstance(tm.obs, tobs.Poisson)
    assert tm.dim == 7 and tm.structure() == ("L", "L")
