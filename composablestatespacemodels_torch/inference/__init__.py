from . import filter as filter_mod
from . import kalman, resampling
from .filter import (FilterResult, PfSummary, bootstrap_filter,
                     credible_interval_eta, credible_interval_state,
                     log_likelihood)
from .kalman import KalmanResult, kalman_filter

__all__ = [
    "resampling", "kalman",
    "bootstrap_filter", "log_likelihood", "FilterResult", "PfSummary",
    "credible_interval_eta", "credible_interval_state",
    "kalman_filter", "KalmanResult",
]
