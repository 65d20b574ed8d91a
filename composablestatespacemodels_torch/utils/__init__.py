from . import data
from .data import (SimulatedData, TimeSeries, simulate, simulate_lgcp,
                   simulate_regular, simulate_sde_grid)

__all__ = ["data", "TimeSeries", "SimulatedData", "simulate",
           "simulate_regular", "simulate_sde_grid", "simulate_lgcp"]
