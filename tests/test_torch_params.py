"""The port's flat-vector and proposal layer and its chain axis, against the
JAX package on identical inputs.

* ``flatten_params``, ``param_names``, ``add_flat``: bit for bit
  (``ravel_pytree``'s order is the reference's flatten order).
* ``covariance_params``: rtol 1e-5 (both float32; the sums differ in
  order).
* ``perturb`` / ``perturb_mvn``: statistics of many draws (the two
  packages draw different streams).
* Parameters with a leading chain axis: ``transition_coeffs``,
  ``initial_state_t``, ``obs_scale`` and ``make_consts`` equal the stack of
  the per-chain results bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.models import params as tp_
from composablestatespacemodels_torch.models.tree import tree_map
from composablestatespacemodels_tpu.models import params as jp_

from _torch_parity import both

MODELS = ["flagship", "oracle", "seasonal_linear"]


@pytest.mark.parametrize("name", MODELS)
def test_flatten_names_add_flat_match_jax(name):
    _, jp, _, tp = both(name)
    flat_j = np.asarray(jp_.flatten_params(jp))
    flat_t = tp_.flatten_params(tp)
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    assert tp_.param_names(tp) == jp_.param_names(jp)
    assert tp_.param_size(tp) == jp_.param_size(jp)
    delta = np.random.default_rng(0).normal(size=flat_j.shape).astype(
        np.float32)
    np.testing.assert_array_equal(
        tp_.flatten_params(tp_.add_flat(tp, torch.from_numpy(delta))).numpy(),
        np.asarray(jp_.flatten_params(jp_.add_flat(jp, jnp.asarray(delta)))))


def test_unconstrained_constructors_match_jax():
    args = ([0.1, 0.2], [0.3], [0.4, 0.5], [0.6], [0.7, 0.8])
    for name, k in (("brownian_params_unconstrained", 3),
                    ("gen_brownian_params_unconstrained", 4),
                    ("ou_params_unconstrained", 5)):
        rt = getattr(tp_, name)(*args[:k])
        rj = getattr(jp_, name)(*args[:k])
        np.testing.assert_array_equal(tp_.flatten_params(rt).numpy(),
                                      np.asarray(jp_.flatten_params(rj)))
        assert rt.names() == rj.names()


def test_covariance_mean_stack_match_jax():
    _, jp, _, tp = both("seasonal_linear")
    rng = np.random.default_rng(1)
    p = jp_.param_size(jp)
    draws = (rng.normal(size=(200, p)) @ rng.normal(size=(p, p)) * 0.1
             ).astype(np.float32)
    base = np.asarray(jp_.flatten_params(jp))
    stacked_j = jax.vmap(lambda d: jp_.add_flat(jp, d))(jnp.asarray(draws))
    stacked_t = tree_map(lambda t: t.expand((200,) + t.shape), tp)
    stacked_t = tp_.unflatten_params(
        stacked_t, torch.from_numpy(base + draws))
    np.testing.assert_array_equal(tp_.stack_flat(stacked_t).numpy(),
                                  np.asarray(jp_.stack_flat(stacked_j)))
    np.testing.assert_allclose(tp_.covariance_params(stacked_t).numpy(),
                               np.asarray(jp_.covariance_params(stacked_j)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tp_.flatten_params(tp_.mean_params(stacked_t)).numpy(),
        np.asarray(jp_.flatten_params(jp_.mean_params(stacked_j))),
        rtol=1e-5, atol=1e-6)


def test_perturb_statistics():
    _, _, _, tp = both("flagship")
    base = tp_.flatten_params(tp)
    g = torch.Generator().manual_seed(0)
    prop = tp_.perturb(0.04)
    draws = torch.stack([tp_.flatten_params(prop(g, tp)) - base
                         for _ in range(2000)])
    # mean 0, sd 0.2 per entry, independent entries: 2000 draws
    assert draws.mean(0).abs().max() < 4 * 0.2 / np.sqrt(2000)
    np.testing.assert_allclose(draws.std(0).numpy(), 0.2, rtol=0.1)
    corr = np.corrcoef(draws.numpy().T)
    assert np.abs(corr - np.eye(len(base))).max() < 0.12
    # on a chain-batched tree every chain draws its own noise
    pb = tree_map(lambda t: t.expand((64,) + t.shape), tp)
    nb = tp_.flatten_params(prop(g, pb)) - base
    assert nb.shape == (64, len(base))
    assert torch.unique(nb[:, 0]).numel() == 64


@pytest.mark.parametrize("kind", ["mvn", "eigen"])
def test_perturb_mvn_statistics(kind):
    _, _, _, tp = both("oracle")
    p = tp_.param_size(tp)
    rng = np.random.default_rng(2)
    a = rng.normal(size=(p, p))
    cov = (a @ a.T / p * 0.01 + 0.001 * np.eye(p)).astype(np.float32)
    prop = (tp_.perturb_mvn(np.linalg.cholesky(cov)) if kind == "mvn"
            else tp_.perturb_mvn_eigen(cov))
    base = tp_.flatten_params(tp)
    pb = tree_map(lambda t: t.expand((20000,) + t.shape), tp)
    draws = (tp_.flatten_params(prop(torch.Generator().manual_seed(3), pb))
             - base).numpy()
    np.testing.assert_allclose(np.cov(draws.T), cov, rtol=0.1,
                               atol=0.05 * np.abs(cov).max())
    assert np.abs(draws.mean(0)).max() < 4 * np.sqrt(cov.max() / 20000)


def _chains(tp, b, seed):
    """B chains: the model's parameters plus per-chain offsets."""
    g = torch.Generator().manual_seed(seed)
    flat = tp_.flatten_params(tp)
    pb = tree_map(lambda t: t.expand((b,) + t.shape), tp)
    return tp_.unflatten_params(
        pb, flat + 0.1 * torch.randn((b, flat.shape[0]), generator=g))


@pytest.mark.parametrize("name", MODELS)
def test_chain_axis_models_equal_stacked_chains(name):
    _, _, tm, tp = both(name)
    b, n = 5, 16
    pb = _chains(tp, b, 4)
    one = [tree_map(lambda t: t[i], pb) for i in range(b)]
    dt = torch.tensor([0.0, 0.5, 1.0, 2.5])
    coefs = tm.sde.transition_coeffs(tm.sde_params(pb), dt[:, None])
    for k, c in enumerate(coefs):
        assert c.shape == (4, b, tm.dim)
        want = torch.stack([tm.sde.transition_coeffs(tm.sde_params(p), dt)[k]
                            for p in one], dim=1)
        assert torch.equal(c, want)
    x = tm.initial_state_t(pb, torch.Generator().manual_seed(5), n)
    g = torch.Generator().manual_seed(5)
    assert x.shape == (b, tm.dim, n)
    assert torch.equal(x, torch.stack([tm.initial_state_t(p, g, n)
                                       for p in one]))
    scale = tm.obs_scale(pb)
    assert scale.shape == (b,)
    assert torch.equal(scale, torch.stack([tm.obs_scale(p) for p in one]))
    make_consts, _ = tm.obs.kernel_log_density()
    y = torch.tensor([0.0, 1.0, 3.0, 2.0])
    c = make_consts(y[:, None], scale)
    assert c.shape[:2] == (4, b)
    assert torch.equal(c, torch.stack([make_consts(y, s) for s in scale],
                                      dim=1))


def test_chain_axis_moments_concatenate_state_dims():
    """A composite SDE's batched moments concatenate state dimensions, not
    chains (``[B, d]``)."""
    _, _, tm, tp = both("flagship")
    m0, c0 = tm.sde.initial_moments(tm.sde_params(_chains(tp, 3, 6)))
    assert m0.shape == (3, 7) and c0.shape == (3, 7)


def test_tree_map_over_two_trees_selects():
    _, _, _, tp = both("flagship")
    other = tp_.add_flat(tp, torch.ones(tp_.param_size(tp)))
    picked = tree_map(lambda a, b: torch.where(torch.tensor(True), b, a),
                      tp, other)
    assert torch.equal(tp_.flatten_params(picked),
                       tp_.flatten_params(other))
    assert picked.left.value.scale is None
