"""The port's observation families and their K3 twins against the JAX
package, on identical inputs made with numpy.

Each pointwise family's ``log_density`` and ``make_consts`` are held to
JAX's; the twin of its K3 device function (``kernel_fn``), fed JAX's
constants, to JAX's in-kernel ``fn``, and, fed the port's constants, to
the port's ``log_density``.  On the card ``chip_smoke.py`` holds each
device function to its twin bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.models import observation as tob
from composablestatespacemodels_tpu.models import observation as job

# family -> (constructor arguments, observations, constrained scales)
FAMILIES = {
    "Gaussian": ({}, (0.7, -1.3), (0.4, 2.0)),
    "Poisson": ({}, (0.0, 3.0, 11.0), (1.0,)),
    "ZeroInflatedPoisson": ({}, (0.0, 3.0), (0.3, 0.7)),
    "NegativeBinomial": ({}, (0.0, 5.0, 23.0), (0.8, 3.0)),
    "Bernoulli": ({}, (0.0, 1.0), (1.0,)),
    "StudentsT": ({"df": 5}, (1.2, -4.0), (0.4, 1.5)),
    "Beta": ({}, (0.05, 0.37, 0.9), (0.5, 3.0)),
}
NAMES = sorted(FAMILIES)
# gamma grid: a = exp(-gamma) in [0.018, 55] for Beta, lambda up to 55 for
# the counts, and both sides of Bernoulli's clamp at |gamma| = 6
GAMMAS = np.concatenate([np.linspace(-4.0, 4.0, 201),
                         [-6.5, -6.0, 6.0, 6.5]]).astype(np.float32)
EPS = 2.0 ** -23   # one float32 ulp, relative


def _stirling_terms(x):
    """``|(z - 0.5) log z| + |log prod|`` of the Stirling lgamma at ``x``
    (float64): the largest intermediates, whose rounding -- and each
    library's own ``log`` -- the float32 result inherits."""
    x = np.asarray(x, np.float64)
    z = np.where(x >= 8.0, x, x + 8.0)
    prod = np.prod([x + i for i in range(8)], axis=0)
    corr = np.where(x >= 8.0, 0.0, np.log(np.where(x >= 8.0, 1.0, prod)))
    return np.abs((z - 0.5) * np.log(z)) + np.abs(corr)


def _assert_close(got, want, rtol, atol, msg=""):
    """``|got - want| <= atol + rtol |want|`` elementwise, ``atol`` an
    array or a float."""
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    k = int(np.argmax(excess))
    assert excess[k] <= 0, (f"{msg}: at {k} got {got[k]!r} want {want[k]!r}"
                            f" (over by {excess[k]:.3g})")


def _beta_terms(y, s):
    """The sum of the absolute terms of Beta's log-density on ``GAMMAS``
    (float64): a few float32 ulps of it bound the rounding of a result
    that cancels lgammas of up to ~170."""
    a = np.exp(-GAMMAS.astype(np.float64))
    lg = np.vectorize(math.lgamma)
    return (np.abs((a - 1.0) * math.log(y)) + abs((s - 1.0) * math.log1p(-y))
            + np.abs(lg(a + s)) + np.abs(lg(a)) + abs(math.lgamma(s)))


def _fams(name):
    kwargs = FAMILIES[name][0]
    return getattr(tob, name)(**kwargs), getattr(job, name)(**kwargs)


def _cases(name):
    _, ys, scales = FAMILIES[name]
    return [(y, s) for y in ys for s in scales]


def _jax_consts(jfam, y, scale):
    make_consts, _ = jfam.kernel_log_density()
    return np.asarray(make_consts(jnp.float32(y), jnp.float32(scale)))


def _with_df(name, c, fam):
    """JAX's StudentsT closes over ``df``; the port reads ``(df + 1)/2`` and
    ``df`` from the two slots after JAX's three constants."""
    if name != "StudentsT":
        return c
    nu = float(fam.df)
    return np.concatenate([c, np.float32([(nu + 1.0) / 2.0, nu])])


@pytest.mark.parametrize("name", NAMES)
def test_log_density_matches_jax(name):
    tfam, jfam = _fams(name)
    for y, s in _cases(name):
        got = tfam.log_density(torch.tensor(GAMMAS), torch.tensor(y),
                               torch.tensor(s)).numpy()
        want = np.asarray(jfam.log_density(jnp.asarray(GAMMAS),
                                           jnp.float32(y), jnp.float32(s)))
        # atol: the densities sum terms up to ~170 (lgammas, exp(gamma))
        # whose float32 rounding, in each package's own lgamma, leaves a
        # few of their ulps on a small result
        atol = 1e-5 if name != "Beta" else np.maximum(
            1e-5, 4 * EPS * _beta_terms(y, s))
        _assert_close(got, want, 1e-5, atol, f"y={y} scale={s}")


@pytest.mark.parametrize("name", NAMES)
def test_make_consts_matches_jax(name):
    tfam, jfam = _fams(name)
    make_consts, fid = tfam.kernel_log_density()
    assert fid == getattr(tob, {"ZeroInflatedPoisson": "ZERO_INFLATED_POISSON",
                                "NegativeBinomial": "NEGATIVE_BINOMIAL",
                                "StudentsT": "STUDENTS_T"}.get(
                                    name, name.upper()) + "_ID")
    for y, s in _cases(name):
        got = make_consts(torch.tensor(y), torch.tensor(s)).numpy()
        want = _with_df(name, _jax_consts(jfam, y, s), tfam)
        assert got.shape == want.shape and got.shape[-1] <= tob.KERNEL_CONSTS
        # NB's first constant is three lgammas, rounded in each package's
        # own lgamma; the absolute floor is that lgamma's error at its zero
        # (JAX's float32 lgamma(1) is 4.8e-7)
        rtol = np.array([1e-5 if name == "NegativeBinomial" and k == 0
                         else 1e-6 for k in range(got.shape[-1])])
        np.testing.assert_array_less(
            np.abs(got - want), rtol * np.abs(want) + 1e-6,
            err_msg=f"y={y} scale={s}")


@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_jax_fn(name):
    """The K3 twin on JAX's constants against JAX's in-kernel ``fn``."""
    tfam, jfam = _fams(name)
    _, fn = jfam.kernel_log_density()
    twin = tob.kernel_fn(tfam.kernel_log_density()[1])
    rtol = 3e-6 if name == "Beta" else 1e-6
    a = np.exp(-GAMMAS.astype(np.float64))
    for y, s in _cases(name):
        c = _jax_consts(jfam, y, s)
        want = np.asarray(fn(jnp.asarray(GAMMAS), jnp.asarray(c)))
        got = twin(torch.tensor(GAMMAS),
                   torch.tensor(_with_df(name, c, tfam))).numpy()
        # Beta: two ulps of each Stirling lgamma's large intermediates,
        # where the two libraries' logf may differ by an ulp
        atol = 1e-6 if name != "Beta" else np.maximum(
            1e-6, 2 * EPS * (_stirling_terms(a) + _stirling_terms(a + s)))
        _assert_close(got, want, rtol, atol, f"y={y} scale={s}")


@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_log_density(name):
    """The twin on the port's constants computes the port's
    ``log_density`` (Beta through the Stirling lgamma: 1e-4, as the JAX
    package's own test)."""
    tfam, _ = _fams(name)
    make_consts, fid = tfam.kernel_log_density()
    tol = 1e-4 if name == "Beta" else 1e-5
    g = torch.tensor(GAMMAS)
    for y, s in _cases(name):
        c = make_consts(torch.tensor(y), torch.tensor(s))
        np.testing.assert_allclose(
            tob.kernel_fn(fid)(g, c).numpy(),
            tfam.log_density(g, torch.tensor(y), torch.tensor(s)).numpy(),
            rtol=tol, atol=tol, err_msg=f"y={y} scale={s}")


def test_lgamma_f32_twin_vs_float64():
    """Beta's Stirling lgamma twin against ``torch.lgamma`` in float64 on
    the JAX package's grid (``tests/test_observation.py``)."""
    x = np.concatenate([np.logspace(-4, 4, 500, dtype=np.float32),
                        np.linspace(0.01, 20.0, 500, dtype=np.float32)])
    got = tob._lgamma_f32(torch.tensor(x)).double()
    want = torch.lgamma(torch.tensor(x, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-6,
                               atol=3e-6)
    # and op for op the JAX package's function, to two ulps of the largest
    # intermediates (the libraries' logf may differ by an ulp)
    _assert_close(tob._lgamma_f32(torch.tensor(x)).numpy(),
                  np.asarray(job._lgamma_f32(jnp.asarray(x))), 1e-6,
                  np.maximum(1e-6, 2 * EPS * _stirling_terms(x)))


@pytest.mark.parametrize("name", NAMES)
def test_make_consts_chain_batched(name):
    """``y [T]`` against a chain-batched ``scale [B]`` gives ``[T, B, k]``,
    equal to the per-chain calls stacked."""
    tfam, _ = _fams(name)
    make_consts, _ = tfam.kernel_log_density()
    _, ys, scales = FAMILIES[name]
    y = torch.tensor(ys * 2, dtype=torch.float32)
    scale = torch.tensor(scales * 2, dtype=torch.float32)
    got = make_consts(y[:, None], scale)
    want = torch.stack([make_consts(y, scale[b])
                        for b in range(scale.shape[0])], dim=1)
    assert got.shape == want.shape == (y.shape[0], scale.shape[0],
                                       want.shape[-1])
    assert torch.equal(got, want)


def _moments(name, gamma, s, df=5):
    """Mean and variance of y given gamma and the constrained scale."""
    if name == "Gaussian":
        return gamma, s * s
    if name == "Poisson":
        lam = math.exp(gamma)
        return lam, lam
    if name == "ZeroInflatedPoisson":
        lam = math.exp(gamma)
        return (1 - s) * lam, (1 - s) * lam * (1 + s * lam)
    if name == "NegativeBinomial":
        mu = math.exp(gamma)
        return mu, mu + mu * mu / s
    if name == "Bernoulli":
        p = 1.0 / (1.0 + math.exp(-gamma))
        return p, p * (1 - p)
    if name == "StudentsT":
        return gamma, s * s * df / (df - 2)
    a, b = math.exp(-gamma), s
    return a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))


@pytest.mark.parametrize("name", NAMES)
def test_sampler_support_and_moments(name):
    """20k draws: in the family's support, mean and variance within 4
    standard errors (the variance's from the draws' own fourth moment)."""
    tfam, _ = _fams(name)
    gamma, s = 0.6, FAMILIES[name][2][-1]
    n = 20000
    ys = tfam.sample(torch.Generator().manual_seed(11),
                     torch.full((n,), gamma), torch.tensor(s)).double()
    assert ys.shape == (n,) and bool(torch.isfinite(ys).all())
    if name in ("Poisson", "ZeroInflatedPoisson", "NegativeBinomial"):
        assert bool(((ys >= 0) & (ys == torch.round(ys))).all())
    if name == "Bernoulli":
        assert set(ys.unique().tolist()) <= {0.0, 1.0}
    if name == "Beta":
        assert bool(((ys > 0) & (ys < 1)).all())
    mean, var = _moments(name, gamma, s)
    dev2 = (ys - ys.mean()) ** 2
    assert abs(float(ys.mean()) - mean) <= 4 * math.sqrt(var / n), name
    if name != "StudentsT":   # df = 5: the fourth moment is infinite
        assert abs(float(dev2.mean()) - var) <= 4 * float(
            dev2.std()) / math.sqrt(n), name


def test_lgcp_raises_as_jax():
    tfam, jfam = tob.LogGaussianCox(), job.LogGaussianCox()
    assert tfam.kernel_log_density() is None
    for call in ("log_density", "sample"):
        with pytest.raises(NotImplementedError) as want:
            getattr(jfam, call)(jax.random.PRNGKey(0) if call == "sample"
                                else jnp.float32(0.0), jnp.float32(1.0), None)
        with pytest.raises(NotImplementedError, match=str(want.value)):
            getattr(tfam, call)(torch.Generator() if call == "sample"
                                else torch.tensor(0.0), torch.tensor(1.0),
                                None)


@pytest.mark.parametrize("make,family", [
    (lambda s: ct.students_t(s, df=7), "StudentsT"),
    (ct.bernoulli, "Bernoulli"), (ct.beta, "Beta"),
    (ct.negative_binomial, "NegativeBinomial"),
    (ct.zero_inflated_poisson, "ZeroInflatedPoisson"),
    (ct.lgcp, "LogGaussianCox"),
])
def test_constructors(make, family):
    model = make(ct.ou_process(1))
    assert type(model.obs).__name__ == family
    assert model.dim == 1
    if family == "StudentsT":
        assert model.obs.df == 7
    if family == "ZeroInflatedPoisson":   # the zero-inflation probability
        assert float(model.obs.constrain_scale(torch.tensor(0.0))) == 0.5
