"""composablestatespacemodels_torch: the PyTorch / CUDA port of
composablestatespacemodels_tpu for an NVIDIA H100.

The JAX package beside it is the reference.  This package imports torch
and numpy, never JAX.  Its bootstrap particle filter runs on CUDA kernels
written by hand for Hopper (``csrc/``): K1, the systematic resampling
counts; K2, the fused resample + exact propagate, which evaluates the
observation log-density (K3) in the same pass (``log_likelihood``); K4,
the resampling gather; K5, the standalone propagate + log-density
(``bootstrap_filter`` with a store mode); K7a/K7b, the prefix sum and
running max behind the stratified counts; K6 batched, the systematic
counts of many chains at once, and K8, many chains' whole filter in one
launch (PMMH: ``pmmh``, ``pmmh_chains``, ``adaptive_pmmh``,
``pilot_run``).  K3 evaluates any of the seven pointwise observation
families (Gaussian, Poisson, zero-inflated Poisson, negative binomial,
Bernoulli, Student-t, Beta) inside K2, K5 and K8.  ``bootstrap_filter``
takes every resampling scheme of the JAX package and a custom one, and
forecasting advances a filtering cloud or posterior draws.
``interpolation_filter`` smooths through gaps from the filter's genealogy
and ``lgcp_filter`` filters a log-Gaussian Cox process on a fine grid,
both resampling through K1 + K4 or K7a + K7b + K4.  On CPU tensors the
kernels' plain PyTorch versions run instead.
"""

__version__ = "0.1.0"

from . import inference, models, ops, utils
from .inference import (FilterResult, Forecast, ForecastCloud, KalmanResult,
                        PfSummary, PmmhResult, PmmhState, adaptive_pmmh,
                        bootstrap_filter, credible_interval_eta,
                        credible_interval_state, effective_chain_size,
                        forecast, forecast_cloud, forecast_from_posterior,
                        forecast_times, gelman_rubin, interpolation_filter,
                        kalman_filter, lgcp_filter, log_likelihood,
                        make_pf_loglik, make_pf_loglik_chains, pilot_run,
                        pmmh_chains)
from .inference.pmmh import pmmh
from .models import (bernoulli, beta, branch, brownian_motion,
                     brownian_params, compose, gen_brownian_motion,
                     gen_brownian_params, leaf, lgcp, linear,
                     negative_binomial, ou_params, ou_process, param_node,
                     parameters, params_from_numpy, poisson, seasonal,
                     students_t, zero_inflated_poisson)
from .utils import (SimulatedData, TimeSeries, simulate, simulate_lgcp,
                    simulate_regular)

__all__ = [
    "models", "inference", "ops", "utils",
    "poisson", "linear", "seasonal", "students_t", "bernoulli", "beta",
    "negative_binomial", "zero_inflated_poisson", "lgcp", "compose",
    "brownian_motion", "gen_brownian_motion", "ou_process",
    "brownian_params", "gen_brownian_params", "ou_params",
    "param_node", "parameters", "params_from_numpy", "leaf", "branch",
    "bootstrap_filter", "log_likelihood", "FilterResult", "PfSummary",
    "forecast", "forecast_cloud", "forecast_times", "forecast_from_posterior",
    "Forecast", "ForecastCloud", "credible_interval_eta", "credible_interval_state",
    "kalman_filter", "KalmanResult", "lgcp_filter", "interpolation_filter",
    "pmmh", "pmmh_chains", "adaptive_pmmh", "make_pf_loglik",
    "make_pf_loglik_chains", "pilot_run", "gelman_rubin",
    "effective_chain_size", "PmmhResult", "PmmhState",
    "TimeSeries", "SimulatedData", "simulate", "simulate_regular",
    "simulate_lgcp",
]
