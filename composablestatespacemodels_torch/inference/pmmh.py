"""Particle-marginal Metropolis-Hastings (PMMH).

PyTorch port of ``composablestatespacemodels_tpu/inference/pmmh.py``
(reference PMMH.scala).  The JAX package runs the chain as one
``lax.scan`` and independent chains under ``vmap``; here the chain is a
host loop that never reads the device (the accept and the select are
``torch.where`` on the device), and chains are an explicit leading axis.

Semantic invariants preserved (PMMH.scala):

* acceptance log-ratio
  ``ll' + q(prop -> cur) + prior(prop) - q(cur -> prop) - ll - prior(cur)``
  (:72-73);
* the cached-likelihood variant reuses the previous PF estimate
  (ParticleMetropolisHastings, :114-123); the ``approx`` variant re-runs the
  filter for the current parameters every iteration (ApproxPMMH, :128-153);
* initial ll = -1e99 so the first proposal is always accepted (:121)
  (clamped to -1e30 here: finite in float32).

The likelihood tiers, as in the JAX package:

* :func:`make_pf_loglik` -- one chain's ``bootstrap_filter(store="ll")``
  (``resample="systematic"``: K1 and K4 per step), or with
  ``fused_sweep=True`` the whole filter in one K8 launch;
* ``pmmh_chains`` over the chain axis -- the callable's batched form, the
  chain-axis filter with K6 batched per step;
* ``pmmh_chains(pf_ll_chains=make_pf_loglik_chains(...))`` -- every
  chain's filter in one K8 launch per iteration.

Contract of the chain axis.  Under :func:`pmmh_chains` the ``proposal``,
``prior`` and ``log_transition`` receive chain-batched trees (every tensor
with a leading axis of ``n_chains``) and return ``[n_chains]`` values (or
a scalar that broadcasts); :func:`~..models.params.perturb` and its MVN
variants draw independent noise per chain.  A ``pf_ll`` with no batched
form (no ``.chains`` attribute, e.g. a user's own evaluator) runs chain by
chain on the host, and then the three receive one chain's tree each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models.model import Model
from ..models.params import (_leaves, covariance_params, perturb,
                             perturb_mvn_eigen, params_to)
from ..models.tree import Tree, tree_map
from ..utils.data import TimeSeries
from .filter import _check_scheme, _filter_ll_chains, _run

_INIT_LL = -1e30
_NEEDS_STATE = ("store_state=True requires an evaluator returning (ll, state)"
                " -- build it with make_pf_loglik(..., store_state=True) or "
                "make_pf_loglik_chains(..., store_state=True)")


def flat_prior(params):
    """Improper flat prior (the reference examples' default,
    DetermineParameters.scala:73)."""
    return 0.0


def symmetric_transition(frm, to):
    """q(a -> b) = q(b -> a): cancels in the acceptance ratio."""
    return 0.0


@dataclasses.dataclass(frozen=True)
class PmmhResult:
    """Stacked chain output (iteration axis first; ``[chains, iters, ...]``
    from :func:`pmmh_chains`).

    Reference: ParamsState/MetropState, PMMH.scala:17-26.  With
    ``store_state`` the chain also carries each iteration's sampled latent
    final state (PMMH.scala:26, ParticleFilter.scala:346-357), so
    ``(params[i], states[i])`` are joint posterior draws.
    """

    params: object                 # tree stacked [iters, ...]
    lls: torch.Tensor              # [iters]
    accepted: torch.Tensor         # [iters] cumulative accepted count (int32)
    states: Optional[torch.Tensor] = None   # [iters, d] (store_state)

    @property
    def n_iters(self) -> int:
        return int(self.lls.shape[-1])

    def acceptance_rate(self) -> torch.Tensor:
        """Mean per-iteration acceptance, from the cumulative count's
        increments clipped to 0/1 (exact for fresh and stitched chains,
        within 1/n for a chain resumed with a prior count)."""
        acc = self.accepted
        inc = torch.diff(acc, dim=-1, prepend=torch.zeros_like(acc[..., :1]))
        return torch.clamp(inc, 0, 1).to(torch.float32).mean(dim=-1)

    def thin(self, burn_in: int = 0, thin: int = 1) -> "PmmhResult":
        """Burn-in and thinning (reference Streaming.readPosterior,
        Streaming.scala:113-140) along the iteration axis: the last axis of
        ``lls`` (axis 0 for one chain, 1 for stacked chains)."""
        axis = self.lls.ndim - 1

        def take(x):
            idx = torch.arange(burn_in, x.shape[axis], thin, device=x.device)
            return torch.index_select(x, axis, idx)

        return PmmhResult(tree_map(take, self.params), take(self.lls),
                          take(self.accepted),
                          None if self.states is None else take(self.states))


@dataclasses.dataclass(frozen=True)
class PmmhState:
    """Resumable chain state (the reference ``MetropState``, PMMH.scala:26).
    ``state`` is the carried sampled latent state under ``store_state``;
    ``()`` otherwise."""

    params: object
    ll: torch.Tensor
    accepted: torch.Tensor
    state: object = ()


def initial_state(params: Tree) -> PmmhState:
    """ll = -1e30 so the first proposal is always accepted (PMMH.scala:121)."""
    device = _leaves(params)[0][0].device
    return PmmhState(params, torch.tensor(_INIT_LL, device=device),
                     torch.tensor(0, dtype=torch.int32, device=device))


def make_pf_loglik(model: Model, data: TimeSeries, n_particles: int,
                   resample: str = "systematic", store_state: bool = False,
                   fused_sweep: bool = False) -> Callable:
    """Bundle a model and data into ``(generator, params) -> ll``: the
    reference ``BootstrapFilter`` Reader (package.scala:23-24,
    ParticleFilter.filterLlState :346-348).

    With ``store_state`` the callable returns ``(ll, state)``, ``state``
    ONE particle sampled uniformly from the final resampled cloud (the
    reference ``filterLlState``'s sampled latent state).

    ``resample`` takes every scheme name of :func:`..filter.bootstrap_filter`.
    ``fused_sweep`` evaluates the likelihood through K8 (n_particles <=
    1024, exact transitions, an observation family with a K3 hook): the
    whole T-step filter in one launch, for exactly the one chain asked
    for.

    The callable has a batched form ``.chains(generator, params_b) -> ll
    [B]`` (or ``(ll [B], state [B, d])``) for chain-batched parameters,
    which :func:`pmmh_chains` and :func:`pilot_run` use: the chain-axis
    filter (K6 batched per step) for ``resample="systematic"``, K8 under
    ``fused_sweep``.  Other schemes have none.  The mask is read to the
    host once, here, so no call reads the device.
    """
    if fused_sweep:
        pf_all = make_pf_loglik_chains(model, data, n_particles,
                                       store_state=store_state)

        def pf_ll_sweep(generator, params):
            out = pf_all(generator, tree_map(lambda t: t[None], params))
            if store_state:
                return out[0][0], out[1][0]
            return out[0]

        pf_ll_sweep.chains = pf_all
        return pf_ll_sweep

    _check_scheme(resample, "ll")
    observed = data.mask.tolist()

    def run(generator, params):
        model.validate_params(params)
        return _run(model, params, data, n_particles, generator, resample,
                    None, None, "ll", None, 0.975, observed)

    def pf_ll(generator, params):
        return run(generator, params).ll

    def pf_ll_state(generator, params):
        res = run(generator, params)
        i = torch.randint(0, n_particles, (), generator=generator,
                          device=generator.device)
        return res.ll, res.final_particles[i]

    def pf_ll_chains(generator, params_b):
        ll, x = _filter_ll_chains(model, params_b, data, n_particles,
                                  generator, observed)
        if not store_state:
            return ll
        return ll, _pick_states(generator, x)

    out = pf_ll_state if store_state else pf_ll
    if resample == "systematic":
        out.chains = pf_ll_chains
    return out


def _pick_states(generator, x: torch.Tensor) -> torch.Tensor:
    """One particle per chain, uniformly, from clouds ``x [B, d, n]``."""
    b, d, n = x.shape
    i = torch.randint(0, n, (b,), generator=generator, device=x.device)
    return torch.gather(x, 2, i[:, None, None].expand(b, d, 1))[:, :, 0]


def make_pf_loglik_chains(model: Model, data: TimeSeries, n_particles: int,
                          store_state: bool = False) -> Callable:
    """Batched-chains log-likelihood through K8.

    Returns ``(generator, params_batched) -> ll [B]``, every chain's full
    bootstrap-filter sweep in ONE launch
    (:func:`..ops.sweep_kernel.pf_sweep_chains`).  Statistically equivalent
    to the chain-axis form of :func:`make_pf_loglik` (different random
    streams); requires ``n_particles <= 1024``, exact transitions and an
    observation family with a K3 hook (the seven pointwise families; a
    family without one raises ``ValueError``).  Feed to :func:`pmmh_chains` as
    ``pf_ll_chains=``.  With ``store_state`` the callable returns ``(ll
    [B], state [B, d])``, per chain one particle of the final cloud.

    Its ``.sweep_inputs(generator, params_batched)`` returns the arguments
    the callable hands K8 for those parameters (the same draws), so a
    check can hold K8 against its plain version at the path's own inputs.
    """
    from ..ops.sweep_kernel import pf_sweep_chains

    wspec = model.obs.kernel_log_density()
    if wspec is None:
        raise ValueError(
            f"{type(model.obs).__name__} has no kernel_log_density hook")
    make_consts, family_id = wspec
    ts = data.ts
    dts = torch.cat([torch.zeros_like(ts[:1]), ts[1:] - ts[:-1]])
    design = model.design_vector(ts).contiguous()                # [T, d]
    y_safe = torch.where(data.mask, data.ys, 0.0)
    mask = data.mask.to(torch.int32)

    def sweep_inputs(generator, params_b):
        params_b = params_to(params_b, generator.device)
        a, b, q = model.sde.transition_coeffs(model.sde_params(params_b),
                                              dts[:, None])      # [T, B, d]
        coef = torch.stack([a, b, torch.sqrt(q)], dim=-1).contiguous()
        wconsts = make_consts(y_safe[:, None],
                              model.obs_scale(params_b)).contiguous()
        x0 = model.initial_state_t(params_b, generator, n_particles)
        seed = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                             device=generator.device, dtype=torch.int64)
        return (x0.contiguous(), coef, design, wconsts, mask,
                seed.to(torch.int32), family_id)

    def pf_ll_all(generator, params_b):
        ll, xf = pf_sweep_chains(*sweep_inputs(generator, params_b))
        if store_state:
            return ll, _pick_states(generator, xf)
        return ll

    pf_ll_all.sweep_inputs = sweep_inputs
    return pf_ll_all


def _log_ratio(ll_prop, ll_cur, prop, cur, prior, log_transition):
    """The acceptance log-ratio, in the JAX package's order of operations
    (its ``pmmh.py:283-284``)."""
    return (ll_prop + log_transition(prop, cur) + prior(prop)
            - log_transition(cur, prop) - ll_cur - prior(cur))


def _select(accept: torch.Tensor, cur, prop):
    """``prop`` where ``accept``, else ``cur``, leaf by leaf; ``accept`` is
    0-d for one chain or ``[B]`` for chain-batched trees."""
    def sel(c, p):
        a = accept.reshape(accept.shape + (1,) * (p.ndim - accept.ndim))
        return torch.where(a, p, c)
    return tree_map(sel, cur, prop)


def _mh_scan(generator, init: PmmhState, pf_ll, proposal, prior,
             log_transition, n_iters: int, approx: bool, store_state: bool,
             n_chains: Optional[int] = None):
    """The MH loop, one chain (``n_chains`` None) or B chains in lockstep
    (every tensor of ``init`` with a leading chain axis).  The accepts and
    selects stay on the device; the loop never waits for it."""
    def eval_ll(p):
        out = pf_ll(generator, p)
        if not store_state:
            return out, None
        if not (isinstance(out, tuple) and len(out) == 2):
            raise ValueError(_NEEDS_STATE)
        return out

    params, ll, state, acc = init.params, init.ll, init.state, init.accepted
    shape = (n_iters,) if n_chains is None else (n_iters, n_chains)
    log_u = torch.log(torch.rand(shape, generator=generator,
                                 device=generator.device))
    out_p, out_ll, out_s, out_acc = [], [], [], []
    for i in range(n_iters):
        prop = proposal(generator, params)
        ll_prop, s_prop = eval_ll(prop)
        if approx:
            # doubly stochastic: refresh the current parameters' estimate
            # too (ApproxPMMH, PMMH.scala:138-152)
            ll_cur, s_cur = eval_ll(params)
        else:
            ll_cur, s_cur = ll, state
        a = _log_ratio(ll_prop, ll_cur, prop, params, prior, log_transition)
        accept = log_u[i] < a
        params = _select(accept, params, prop)
        ll = torch.where(accept, ll_prop, ll_cur)
        if store_state:
            if s_cur is None:   # a fresh chain: the first proposal wins
                s_cur = torch.zeros_like(s_prop)
            state = _select(accept, s_cur, s_prop)
            out_s.append(state)
        acc = acc + accept.to(torch.int32)
        out_p.append(params)
        out_ll.append(ll)
        out_acc.append(acc)
    dim = 0 if n_chains is None else 1
    stack = lambda *xs: torch.stack(xs, dim=dim)  # noqa: E731
    result = PmmhResult(tree_map(stack, *out_p), stack(*out_ll),
                        stack(*out_acc),
                        stack(*out_s) if store_state else None)
    final = PmmhState(params, ll, acc, state if store_state else ())
    return result, final


def _seed_latent(init: PmmhState, store_state: bool) -> PmmhState:
    """The latent-state carry of a chain: dropped when ``store_state`` is
    off (a store_state checkpoint resumed without the flag), None for a
    fresh chain under ``store_state`` (the first evaluation sets its
    shape; the first proposal is always accepted, so nothing of it reaches
    the output)."""
    fresh = isinstance(init.state, tuple) and init.state == ()
    if not store_state:
        return init if fresh else dataclasses.replace(init, state=())
    return dataclasses.replace(init, state=None) if fresh else init


def pmmh(generator: torch.Generator, init_params: Tree, pf_ll: Callable,
         proposal: Callable, n_iters: int, *,
         prior: Callable = flat_prior,
         log_transition: Callable = symmetric_transition,
         approx: bool = False,
         store_state: bool = False,
         init_state: Optional[PmmhState] = None,
         return_state: bool = False):
    """Run one PMMH chain.

    Args:
      generator: ``torch.Generator`` for every draw; the chain runs on its
        device (``init_params`` are moved there).
      init_params: starting parameter tree.
      pf_ll: ``(generator, params) -> ll`` (see :func:`make_pf_loglik`).
      proposal: ``(generator, params) -> params`` (e.g.
        ``models.params.perturb``).
      n_iters: chain length.
      prior: ``params -> log-prior`` (default flat).
      log_transition: ``(from, to) -> log q(to | from)`` (default
        symmetric).
      approx: re-evaluate the current parameters' likelihood each iteration
        (the reference ApproxPMMH).
      store_state: carry each iteration's sampled latent state (the
        reference ``MetropState.state``); ``pf_ll`` must return ``(ll,
        state)`` (``make_pf_loglik(..., store_state=True)``).
      init_state: resume from a previous :class:`PmmhState`; overrides
        ``init_params``.
      return_state: also return the final :class:`PmmhState`.

    Reference call stack: DeterminePosterior, DetermineParameters.scala:55-85.
    """
    if init_state is None:
        init_state = initial_state(params_to(init_params, generator.device))
    result, final = _mh_scan(generator, _seed_latent(init_state, store_state),
                             pf_ll, proposal, prior, log_transition, n_iters,
                             approx, store_state)
    return (result, final) if return_state else result


def pmmh_chains(generator: torch.Generator, init_params: Tree,
                pf_ll: Optional[Callable], proposal: Callable, n_iters: int,
                n_chains: int, *,
                prior: Callable = flat_prior,
                log_transition: Callable = symmetric_transition,
                approx: bool = False,
                store_state: bool = False,
                pf_ll_chains: Optional[Callable] = None) -> PmmhResult:
    """Run ``n_chains`` independent chains from ``init_params`` (the
    reference's ``mapAsync(2)`` thread parallelism,
    DetermineParameters.scala:68-69).  Outputs gain a leading chain axis.

    The chains advance in lockstep on a chain axis when the likelihood has
    a batched form: ``pf_ll_chains`` (``(generator, params_batched) -> ll
    [n_chains]``, see :func:`make_pf_loglik_chains`: every chain's filter
    in one K8 launch per iteration; ``pf_ll`` is then ignored), else
    ``pf_ll.chains`` (:func:`make_pf_loglik`'s chain-axis filter).  A
    ``pf_ll`` without either runs chain by chain.  With ``store_state`` the
    evaluator must return ``(ll, state)``.  See the module docstring for
    what ``proposal``, ``prior`` and ``log_transition`` receive.
    """
    batched = pf_ll_chains or getattr(pf_ll, "chains", None)
    if batched is None:
        runs = [pmmh(generator, init_params, pf_ll, proposal, n_iters,
                     prior=prior, log_transition=log_transition,
                     approx=approx, store_state=store_state)
                for _ in range(n_chains)]
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        return PmmhResult(
            tree_map(stack, *(r.params for r in runs)),
            stack(*(r.lls for r in runs)), stack(*(r.accepted for r in runs)),
            stack(*(r.states for r in runs)) if store_state else None)
    return _pmmh_chains_fused(generator, init_params, batched, proposal,
                              n_iters, n_chains, prior, log_transition,
                              approx, store_state)


def _pmmh_chains_fused(generator, init_params, pf_ll_chains, proposal,
                       n_iters, n_chains, prior, log_transition, approx,
                       store_state=False) -> PmmhResult:
    """The batched MH loop: the proposal, accept and select run on the
    chain axis, and the likelihood of all chains comes from one batched
    evaluation per iteration."""
    device = generator.device
    params0 = tree_map(
        lambda t: t.expand((n_chains,) + t.shape).contiguous(),
        params_to(init_params, device))
    init = PmmhState(params0, torch.full((n_chains,), _INIT_LL,
                                         device=device),
                     torch.zeros(n_chains, dtype=torch.int32, device=device),
                     None if store_state else ())
    return _mh_scan(generator, init, pf_ll_chains, proposal, prior,
                    log_transition, n_iters, approx, store_state,
                    n_chains=n_chains)[0]


def adaptive_pmmh(generator: torch.Generator, init_params: Tree,
                  pf_ll: Callable, n_iters: int, *,
                  pilot_iters: int = 1000,
                  pilot_delta: float = 0.05,
                  burn_in: Optional[int] = None,
                  thin: int = 2,
                  scale: Optional[float] = None,
                  nugget: Optional[float] = None,
                  prior: Callable = flat_prior,
                  log_transition: Callable = symmetric_transition,
                  approx: bool = False,
                  return_pilot: bool = False):
    """Two-phase adaptive PMMH.

    Phase 1 runs a pilot chain with an iid Gaussian random walk
    (``perturb(pilot_delta)``); its thinned sample estimates the parameter
    covariance (``covariance_params``), and phase 2 runs the main chain
    with ``perturb_mvn_eigen(scale * cov + nugget * I)`` from the pilot's
    last state (Parameters.scala:111-123, Utilities.scala:11-18).

    ``scale`` defaults to ``2.38^2 / dim`` (Roberts & Rosenthal), the
    ``nugget`` (diagonal jitter, so that a degenerate pilot cannot freeze
    the main chain) to ``1e-6 * pilot_delta``; ``burn_in`` to half the
    pilot.  Returns the main chain's :class:`PmmhResult` (and the pilot's
    with ``return_pilot``).
    """
    pilot = pmmh(generator, init_params, pf_ll, perturb(pilot_delta),
                 pilot_iters, prior=prior, log_transition=log_transition,
                 approx=approx)
    b = pilot_iters // 2 if burn_in is None else burn_in
    cov = torch.atleast_2d(covariance_params(pilot.thin(b, thin).params))
    dim = cov.shape[0]
    if scale is None:
        scale = 2.38 ** 2 / dim
    if nugget is None:
        nugget = 1e-6 * pilot_delta
    cov = scale * cov + nugget * torch.eye(dim, dtype=cov.dtype,
                                           device=cov.device)
    last = tree_map(lambda t: t[-1], pilot.params)
    result = pmmh(generator, last, pf_ll, perturb_mvn_eigen(cov), n_iters,
                  prior=prior, log_transition=log_transition, approx=approx)
    return (result, pilot) if return_pilot else result


# ---------------------------------------------------------------------------
# diagnostics (reference Streaming.scala:19-105)
# ---------------------------------------------------------------------------


def pilot_run(model: Model, params: Tree, data: TimeSeries,
              generator: torch.Generator,
              particle_counts=(100, 200, 500, 1000, 2000), n_reps: int = 100,
              resample: str = "systematic", fused_sweep: bool = False):
    """Mean and variance of the PF log-likelihood estimate at several
    particle counts, to choose N for PMMH (aim: variance around 1;
    Streaming.pilotRun, :19-40).

    The ``n_reps`` repetitions of a count are independent chains of the
    same parameters: with ``fused_sweep`` one K8 launch for counts <= 1024,
    otherwise the chain-axis filter (``resample="systematic"``) or one
    filter after another (other schemes).  Returns a list of
    ``(n_particles, mean_ll, var_ll)`` (population variance).
    """
    params_b = tree_map(lambda t: t.expand((n_reps,) + t.shape).contiguous(),
                        params)
    out = []
    for n in particle_counts:
        n = int(n)
        if fused_sweep and n <= 1024:
            lls = make_pf_loglik_chains(model, data, n)(generator, params_b)
        else:
            pf_ll = make_pf_loglik(model, data, n, resample)
            if hasattr(pf_ll, "chains"):
                lls = pf_ll.chains(generator, params_b)
            else:
                lls = torch.stack([pf_ll(generator, params)
                                   for _ in range(n_reps)])
        out.append((n, float(torch.mean(lls)),
                    float(torch.var(lls, correction=0))))
    return out


def gelman_rubin(chain_values: torch.Tensor) -> torch.Tensor:
    """Potential scale reduction factor R-hat over ``[n_chains, n_iters]``
    (the reference leaves diagnostics to R/coda, R/Plots.R:97-107)."""
    m, n = chain_values.shape
    if m < 2:
        raise ValueError(
            f"gelman_rubin needs at least 2 chains, got {m} (shape "
            f"[n_chains, n_iters])")
    chain_means = torch.mean(chain_values, dim=1)
    grand = torch.mean(chain_means)
    b = n / (m - 1) * torch.sum((chain_means - grand) ** 2)
    w = torch.mean(torch.var(chain_values, dim=1, correction=1))
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / w)


def effective_chain_size(values: torch.Tensor, max_lag: int = 200) -> float:
    """MCMC effective sample size by the initial-positive-sequence
    autocorrelation, all lags from one FFT."""
    x = values - torch.mean(values)
    n = x.shape[0]
    var = torch.var(values, correction=0)
    max_lag = min(max_lag, n - 1)
    f = torch.fft.rfft(x, 2 * n)
    full = torch.fft.irfft(f * torch.conj(f), 2 * n)[:n]
    acf = full[1:max_lag + 1] / (n * var)
    positive = torch.cumprod((acf > 0).to(acf.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(acf * positive)
    return float(n / torch.clamp(tau, min=1.0))
