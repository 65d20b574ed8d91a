"""Native (C++) runtime tier: high-throughput host-side IO.

The port's own copy of the JAX package's ``native/fastio.cpp``, compiled
on first use with the system toolchain and bound through ctypes; where no
compiler is available every reader and writer of :mod:`..utils.io` runs
its pure-Python version instead, and :func:`available` is False.
"""

from .loader import (available, parse_timeseries_csv, parse_timeseries_json,
                     write_matrix_csv, write_timeseries_csv)

__all__ = ["available", "parse_timeseries_csv", "parse_timeseries_json",
           "write_matrix_csv", "write_timeseries_csv"]
