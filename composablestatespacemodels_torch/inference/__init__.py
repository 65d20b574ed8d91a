from . import filter as filter_mod
from . import kalman, resampling
from .filter import FilterResult, bootstrap_filter, log_likelihood
from .kalman import KalmanResult, kalman_filter

__all__ = [
    "resampling", "kalman",
    "bootstrap_filter", "log_likelihood", "FilterResult",
    "kalman_filter", "KalmanResult",
]
