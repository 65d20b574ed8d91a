from . import filter as filter_mod
from . import kalman, pmmh, resampling
from .filter import (FilterResult, PfSummary, bootstrap_filter,
                     credible_interval_eta, credible_interval_state,
                     log_likelihood)
from .kalman import KalmanResult, kalman_filter
from .pmmh import (PmmhResult, PmmhState, adaptive_pmmh,
                   effective_chain_size, flat_prior, gelman_rubin,
                   initial_state, make_pf_loglik, make_pf_loglik_chains,
                   pilot_run, pmmh_chains, symmetric_transition)

__all__ = [
    "resampling", "kalman", "pmmh",
    "PmmhResult", "PmmhState", "initial_state", "make_pf_loglik",
    "make_pf_loglik_chains", "pmmh_chains", "adaptive_pmmh", "pilot_run",
    "gelman_rubin", "effective_chain_size", "flat_prior",
    "symmetric_transition",
    "bootstrap_filter", "log_likelihood", "FilterResult", "PfSummary",
    "credible_interval_eta", "credible_interval_state",
    "kalman_filter", "KalmanResult",
]
