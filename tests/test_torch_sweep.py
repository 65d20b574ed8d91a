"""K6 batched and K8 of the port (their plain versions, on the CPU) against
the JAX package, K1 and the Kalman oracle.

* K6 batched: row b equals K1's plain version on row b bit for bit; on
  dyadic weights (every prefix exact in any order) it equals the JAX
  kernel it replaces, ``_counts_packed_call``, and ``systematic_counts_fused``
  under ``vmap``, both in interpret mode, bit for bit.
* K8: interpret-mode Pallas draws zero bits, so the JAX kernel's noise is
  a constant times s and its resampling uniform is 2^-25.  The port's step
  function is fed the same (s = 0, u = 2^-25).  Tolerances are the JAX
  test's own (``tests/test_sweep_kernel.py:120-126``): ll rtol 1e-6 /
  atol 1e-5 (the JAX total and prefix are float32 sums, the port's
  float64), x_final rtol 2e-5 / atol 1e-6.  At a masked step the weights
  are uniform and ``n*cdf - u`` sits on an integer up to rounding, so the
  two packages' counts may differ there: a masked last step is compared as
  a multiset (every final particle one of the step's propagated cloud).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.inference import resampling as trs
from composablestatespacemodels_torch.models.observation import (
    GAUSSIAN_ID, POISSON_ID)
from composablestatespacemodels_torch.models.tree import tree_map
from composablestatespacemodels_torch.ops import sweep_kernel as sk
from composablestatespacemodels_torch.ops.scan_kernel import (
    systematic_counts_batched, systematic_counts_batched_ref,
    systematic_counts_fused_ref)
from composablestatespacemodels_tpu.models.observation import Gaussian
from composablestatespacemodels_tpu.ops import scan_kernel as jsk
from composablestatespacemodels_tpu.ops.sweep_kernel import (
    pf_sweep_chains as jax_sweep)

from _torch_parity import both, to_torch_series

U_INTERPRET = np.float32(2.0 ** -25)   # interpret-mode uniform (zero bits)


def _regime_weights(regime, b, n, rng):
    z = rng.normal(size=(b, n))
    w = {"uniform": np.ones((b, n)), "mild": np.exp(0.5 * z),
         "heavy": np.exp(z) ** 4}.get(regime)
    if w is None:
        w = np.full((b, n), 1e-12)
        w[:, n // 3] = 1.0
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("regime", ["uniform", "mild", "heavy", "degenerate"])
@pytest.mark.parametrize("b,n", [(16, 100), (3, 5000)])
def test_k6_batched_rows_equal_k1(regime, b, n):
    rng = np.random.default_rng(n + b)
    w = torch.from_numpy(_regime_weights(regime, b, n, rng))
    total = w.sum(-1)
    u = torch.from_numpy(rng.uniform(size=b).astype(np.float32))
    got = systematic_counts_batched(w, total, u)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    for i in range(b):
        np.testing.assert_array_equal(
            got[i].numpy(),
            systematic_counts_fused_ref(w[i], total[i], u[i]).numpy())
    # through the resampling layer (K6 batched on a card)
    np.testing.assert_array_equal(trs.systematic_counts(w, u).numpy(),
                                  systematic_counts_batched_ref(
                                      w, total, u).numpy())


def _dyadic(b, n, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, (b, n)).astype(np.int64)
    k[:, -1] += 2 ** 15 - k.sum(-1)
    return k.astype(np.float32), np.full(b, 2.0 ** 15, np.float32)


def test_k6_batched_matches_jax_packed_kernel():
    """The TPU kernel K6 batched replaces, run in interpret mode on the same
    weights: dyadic weights make every prefix exact, so both are exact."""
    b, n = 8, 100
    w, total = _dyadic(b, n, 1)
    u = np.float32([0.0, 0.25, 0.5, 0.999, 0.1, 0.7, 0.33, 0.9])
    got = systematic_counts_batched(torch.from_numpy(w),
                                    torch.from_numpy(total),
                                    torch.from_numpy(u)).numpy()
    rows_per = jsk._eff_block_rows(n, 256)
    x = np.zeros((b, rows_per * 128), np.float32)
    x[:, :n] = w
    scal = np.zeros((b, 8, 128), np.float32)
    scal[:, 0, :] = total[:, None]
    scal[:, 1, :] = u[:, None]
    last = ((n - 1) // (128 * rows_per), ((n - 1) % (128 * rows_per)) // 128,
            (n - 1) % 128)
    packed = jsk._counts_packed_call(
        n, last, rows_per, jnp.asarray(scal),
        jnp.asarray(x.reshape(b, rows_per, 128)), interpret=True)
    np.testing.assert_array_equal(got,
                                  np.asarray(packed).reshape(b, -1)[:, :n])
    vmapped = jax.vmap(lambda wi, ti, ui: jsk.systematic_counts_fused(
        wi, ti, ui, interpret=True))(jnp.asarray(w), jnp.asarray(total),
                                     jnp.asarray(u))
    np.testing.assert_array_equal(got, np.asarray(vmapped))


def test_k6_batched_wrapper_devices():
    w = torch.rand(2, 64)
    with pytest.raises(ValueError, match="no K6 batched kernel"):
        m = w.to("meta")
        systematic_counts_batched(m, m.sum(-1), m[:, 0])
    # the resampling layer's [B, N] route gives N counts per row, no other n
    with pytest.raises(ValueError, match="counts per row"):
        trs.systematic_counts(w, w[:, 0], 32)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------


def _sweep_inputs(n, d, b, t_steps, seed):
    """The JAX test's inputs (tests/test_sweep_kernel.py:89-110), made with
    numpy: s = 0, Gaussian weights with a per-chain scale."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(b, d, n)).astype(np.float32)
    coef = np.stack([0.9 + 0.1 * rng.uniform(size=(t_steps, b, d)),
                     0.1 * rng.normal(size=(t_steps, b, d)),
                     np.zeros((t_steps, b, d))], -1).astype(np.float32)
    design = rng.normal(size=(t_steps, d)).astype(np.float32)
    ys = np.linspace(-1.0, 1.0, t_steps).astype(np.float32)
    scales = (0.5 + np.arange(b) / b).astype(np.float32)
    make_consts, _ = Gaussian().kernel_log_density()
    wconsts = np.asarray(jax.vmap(lambda y: jax.vmap(
        lambda s: make_consts(y, s))(jnp.asarray(scales)))(jnp.asarray(ys)))
    return x0, coef, design, wconsts


def _port_step(x, coef_t, design_t, wconsts_t, observed):
    """The port's K8 step, fed the interpret-mode draws (z = 0, u =
    2^-25); returns the new clouds, the ll increments and the number of
    counts per chain whose ``n*cdf - u`` lies within ``n^2 2^-24`` of an
    integer (the float32 error bound of the JAX prefix, times n): the
    counts that may differ between the packages."""
    b, d, n = x.shape
    x, coef_t, design_t, wconsts_t = (torch.from_numpy(np.asarray(v)) for v
                                      in (x, coef_t, design_t, wconsts_t))
    u = torch.full((b,), float(U_INTERPRET))
    x_new, inc = sk.pf_sweep_step_ref(
        x, coef_t, design_t, wconsts_t, observed, GAUSSIAN_ID,
        torch.zeros((b, d, n)), u,
        torch.tensor(math.log(n), dtype=torch.float32))
    # the step's cdf, as the step computes it
    x1 = coef_t[:, :, 0, None] * x + coef_t[:, :, 1, None]
    gamma = torch.einsum("r,brn->bn", design_t.double(), x1.double()).float()
    lw = (Gaussian().kernel_log_density()[1](gamma, wconsts_t.T[..., None])
          if observed else torch.zeros_like(gamma))
    w = torch.exp(lw - lw.max(-1, keepdim=True).values)
    total = trs._tile_sums(trs._tile_pad(w)).to(torch.float32)
    v = (n * trs._cumsum_ref(w / total) - u[:, None]).double().numpy()
    ties = (np.abs(v - np.round(v)) <= n * n * 2.0 ** -24).sum(-1)
    return x_new.numpy(), inc.numpy(), ties


def _jax_sweep(x0, coef, design, wconsts, mask):
    with pltpu.force_tpu_interpret_mode():
        ll, xf = jax_sweep(jnp.asarray(x0), jnp.asarray(coef),
                           jnp.asarray(design), jnp.asarray(wconsts),
                           jnp.asarray(mask), jnp.asarray([7], jnp.int32),
                           weight_family=Gaussian())
    return np.asarray(ll), np.asarray(xf)


@pytest.mark.parametrize("n,d,b", [(100, 1, 8), (128, 7, 8), (300, 1, 8),
                                   (1000, 1, 8)])
def test_k8_step_matches_jax_interpret(n, d, b):
    """Step by step from the JAX kernel's own state (its one-step sweeps):
    the ll increment to rtol 1e-6 / atol 1e-5; the resampled clouds to
    rtol 2e-5 / atol 1e-6 in every slot but as many as there are counts at
    a rounding tie (a flipped count moves one slot), and every slot a
    particle of the step's propagated cloud.  Step 3 is masked."""
    t_steps = 6
    x0, coef, design, wconsts = _sweep_inputs(n, d, b, t_steps, n + d)
    mask = np.ones(t_steps, bool)
    mask[3] = False
    x = x0
    for t in range(t_steps):
        sl = slice(t, t + 1)
        inc_j, x_j = _jax_sweep(x, coef[sl], design[sl], wconsts[sl],
                                mask[sl])
        x_p, inc_p, ties = _port_step(x, coef[t], design[t], wconsts[t],
                                      bool(mask[t]))
        np.testing.assert_allclose(inc_p, inc_j, rtol=1e-6, atol=1e-5)
        if not mask[t]:
            assert (inc_p == 0).all() and (inc_j == 0).all()
        close = np.isclose(x_p, x_j, rtol=2e-5, atol=1e-6).all(axis=1)
        assert ((~close).sum(-1) <= ties).all(), (t, (~close).sum(-1), ties)
        cloud = coef[t, :, :, 0, None] * x + coef[t, :, :, 1, None]
        for bi in range(b):
            for di in range(d):
                assert np.isin(np.round(x_p[bi, di], 4),
                               np.round(cloud[bi, di], 4)).all(), (t, bi, di)
        x = x_j


def test_k8_all_masked_gives_zero_ll():
    n, d, b, t_steps = 100, 2, 8, 5
    x0, coef, design, wconsts = _sweep_inputs(n, d, b, t_steps, 3)
    mask = np.zeros(t_steps, bool)
    x = x0
    for t in range(t_steps):
        x, inc, _ = _port_step(x, coef[t], design[t], wconsts[t], False)
        np.testing.assert_array_equal(inc, np.zeros(b))
    ll_j, _ = _jax_sweep(x0, coef, design, wconsts, mask)
    np.testing.assert_array_equal(ll_j, np.zeros(b))
    seed = torch.tensor([5], dtype=torch.int32)
    ll_w, _ = sk.pf_sweep_chains(
        torch.from_numpy(x0), torch.from_numpy(coef),
        torch.from_numpy(design), torch.from_numpy(wconsts),
        torch.zeros(t_steps, dtype=torch.int32), seed, GAUSSIAN_ID)
    assert (ll_w.numpy() == 0.0).all()


def _flagship_chains(b, t_steps, seed):
    jm, jp, tm, tp = both("flagship")
    sim = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(seed),
                              t_steps, dt=1.0)
    params_b = tree_map(lambda t: t.expand((b,) + t.shape).clone(), tp)
    return tm, params_b, sim.to_timeseries()


def test_k8_chain_isolation():
    """Chain b's ll and final cloud do not move when the other chains'
    parameters change (one block per chain, Philox streams keyed by
    chain)."""
    model, params_b, data = _flagship_chains(4, 20, 0)
    pf_all = ct.make_pf_loglik_chains(model, data, 64)
    ll_a = pf_all(torch.Generator().manual_seed(9), params_b)
    other = tree_map(lambda t: t.clone(), params_b)
    other.left.value.sde.mu[1:] += 0.5
    other.right.value.sde.sigma[1:] -= 0.3
    ll_b = pf_all(torch.Generator().manual_seed(9), other)
    assert ll_a[0] == ll_b[0]
    assert (ll_a[1:] != ll_b[1:]).all()


def test_k8_determinism_and_streams():
    model, params_b, data = _flagship_chains(8, 15, 1)
    pf_all = ct.make_pf_loglik_chains(model, data, 32)
    a = pf_all(torch.Generator().manual_seed(3), params_b)
    assert torch.equal(a, pf_all(torch.Generator().manual_seed(3), params_b))
    assert not torch.equal(a, pf_all(torch.Generator().manual_seed(4),
                                     params_b))
    # 8 identical chains draw 8 different streams
    assert len(set(a.tolist())) > 4


def test_k8_sweep_inputs_are_the_callables():
    """``.sweep_inputs`` hands out what the callable gives K8 from the same
    generator state: the plain version on them repeats its lls bit for
    bit, on a chain-batched flagship with a masked step."""
    model, params_b, data = _flagship_chains(3, 12, 2)
    data = data.knock_out(4.0, 5.0)
    pf_all = ct.make_pf_loglik_chains(model, data, 48)
    args = pf_all.sweep_inputs(torch.Generator().manual_seed(6), params_b)
    assert args[0].shape == (3, model.dim, 48) and args[4].tolist().count(0)
    ll, _ = sk.pf_sweep_chains_ref(*args)
    assert torch.equal(ll, pf_all(torch.Generator().manual_seed(6), params_b))


def test_k8_plain_matches_kalman():
    """The plain K8 (the kernel's draws) within 4 standard errors of the
    Kalman ll on the linear-Gaussian oracle."""
    _, jp, tm, tp = both("oracle")
    sim = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(7), 40)
    data = sim.to_timeseries()
    kf = float(ct.kalman_filter(tm, tp, data).ll)
    b = 48
    params_b = tree_map(lambda t: t.expand((b,) + t.shape).clone(), tp)
    lls = ct.make_pf_loglik_chains(tm, data, 128)(
        torch.Generator().manual_seed(11), params_b).numpy()
    se = lls.std(ddof=1) / math.sqrt(b)
    assert abs(lls.mean() - kf) < max(4 * se, 0.05), (lls.mean(), se, kf)


def test_k8_limits_raise():
    x0 = torch.zeros((2, 1, 1025))
    args = (torch.zeros((3, 2, 1, 3)), torch.zeros((3, 1)),
            torch.zeros((3, 2, 2)), torch.ones(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), POISSON_ID)
    with pytest.raises(ValueError, match="n <= 1024"):
        sk.pf_sweep_chains(x0, *args)
    with pytest.raises(ValueError, match="shared memory"):
        sk.pf_sweep_chains(torch.zeros((2, 40, 1024)), *args)
    m = torch.zeros((2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no K8 kernel"):
        sk.pf_sweep_chains(m, *args)


def test_make_pf_loglik_chains_store_state():
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(4.0), np.ones(4), np.ones(4, bool))
    pf_all = ct.make_pf_loglik_chains(tm, series, 16, store_state=True)
    ll, st = pf_all(torch.Generator(),
                    tree_map(lambda t: t.expand((3,) + t.shape), tp))
    assert ll.shape == (3,) and st.shape == (3, tm.dim)
