from . import data
from .data import SimulatedData, TimeSeries, simulate, simulate_regular

__all__ = ["data", "TimeSeries", "SimulatedData", "simulate",
           "simulate_regular"]
