"""The control, the reference in bfloat16 in the system's place, comes out
not correct by the cell's own limits, at a size a CPU test run holds.
On the card it is read at each cell's own size by ``cssm_bench.calibrate``
(see PERF.md)."""

import pytest

from cssm_bench.tests.conftest import LOGLIK, ONLINE, PMMH, small_run, verdict

# the log-likelihood cell at its own series length: the bfloat16 running
# log-likelihood stalls once its spacing passes the increments; its window
# long enough for the two calls a spread needs
SIZES = {LOGLIK: {"n_particles": 256, "n_obs": 1000}, ONLINE: {}, PMMH: {}}
SECONDS = {LOGLIK: 6.0, ONLINE: 1.0, PMMH: 1.0}


@pytest.mark.parametrize("workload", [LOGLIK, ONLINE, PMMH])
def test_control_is_not_correct(workload):
    run = small_run(workload, seconds=SECONDS[workload], **SIZES[workload])
    assert verdict(run, run.driver.check(run))
    assert not verdict(run, run.driver.control(run))
