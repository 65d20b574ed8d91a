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
``pilot_run``).  On CPU tensors the kernels' plain PyTorch versions run
instead.
"""

__version__ = "0.1.0"

from . import inference, models, ops, utils
from .inference import (FilterResult, KalmanResult, PfSummary, PmmhResult,
                        PmmhState, adaptive_pmmh, bootstrap_filter,
                        credible_interval_eta, credible_interval_state,
                        effective_chain_size, gelman_rubin, kalman_filter,
                        log_likelihood, make_pf_loglik,
                        make_pf_loglik_chains, pilot_run, pmmh_chains)
from .inference.pmmh import pmmh
from .models import (branch, brownian_motion, brownian_params, compose,
                     gen_brownian_motion, gen_brownian_params, leaf, linear,
                     ou_params, ou_process, param_node, parameters,
                     params_from_numpy, poisson, seasonal)
from .utils import SimulatedData, TimeSeries, simulate, simulate_regular

__all__ = [
    "models", "inference", "ops", "utils",
    "poisson", "linear", "seasonal", "compose",
    "brownian_motion", "gen_brownian_motion", "ou_process",
    "brownian_params", "gen_brownian_params", "ou_params",
    "param_node", "parameters", "params_from_numpy", "leaf", "branch",
    "bootstrap_filter", "log_likelihood", "FilterResult", "PfSummary",
    "credible_interval_eta", "credible_interval_state",
    "kalman_filter", "KalmanResult",
    "pmmh", "pmmh_chains", "adaptive_pmmh", "make_pf_loglik",
    "make_pf_loglik_chains", "pilot_run", "gelman_rubin",
    "effective_chain_size", "PmmhResult", "PmmhState",
    "TimeSeries", "SimulatedData", "simulate", "simulate_regular",
]
