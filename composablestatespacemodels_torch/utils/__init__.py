from . import checkpoint, data, io, plots, profiling, streaming
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import (SimulatedData, TimeSeries, simulate, simulate_lgcp,
                   simulate_regular, simulate_sde_grid,
                   timeseries_from_timestamps, timestamps_of)
from .io import (metrop_state_from_json, metrop_state_to_json,
                 read_metrop_states_json, write_metrop_states_json,
                 pf_state_from_json, pf_state_to_json, read_params_json,
                 read_pf_states_json, read_posterior_json,
                 read_timeseries_csv, read_timeseries_json,
                 state_space_from_json, state_space_to_json,
                 write_params_json, write_pf_states_json,
                 read_timestamped_json, write_posterior_json,
                 write_timeseries_csv, write_timeseries_json,
                 write_timestamped_json)
from .streaming import (OnlineFilter, ascii_histogram, min_sink,
                        monitor_stream, pmmh_monitored,
                        windowed_mean_params)

__all__ = [
    "data", "io", "streaming", "checkpoint", "plots", "profiling",
    "TimeSeries", "SimulatedData", "simulate", "simulate_regular",
    "simulate_sde_grid", "simulate_lgcp", "timeseries_from_timestamps",
    "timestamps_of",
    "read_timeseries_csv", "write_timeseries_csv", "read_timeseries_json",
    "write_timeseries_json", "read_timestamped_json",
    "write_timestamped_json", "read_params_json", "write_params_json",
    "read_posterior_json", "write_posterior_json",
    "pf_state_to_json", "pf_state_from_json", "write_pf_states_json",
    "read_pf_states_json", "state_space_to_json", "state_space_from_json",
    "metrop_state_to_json", "metrop_state_from_json",
    "write_metrop_states_json", "read_metrop_states_json",
    "OnlineFilter", "pmmh_monitored", "ascii_histogram",
    "min_sink", "monitor_stream", "windowed_mean_params",
    "save_checkpoint", "restore_checkpoint",
]
