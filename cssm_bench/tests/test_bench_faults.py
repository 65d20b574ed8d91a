"""A run with its timed path broken underneath comes out not correct: once
for each fault the cell can have (its driver's ``FAULTS``)."""

import pytest

from cssm_bench import cell
from cssm_bench.tests.conftest import LOGLIK, ONLINE, PMMH, small_run, verdict


def _faults(workload):
    w = cell.workload(cell.benchmark(), workload)
    return cell.driver(cell.load_json("traffic", w["traffic"])["driver"]).FAULTS


CASES = [(w, f) for w in (LOGLIK, ONLINE, PMMH) for f in _faults(w)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w.split('.')[1]}-{f}" for w, f in CASES])
def test_fault_is_caught(workload, fault):
    run = small_run(workload, fault=fault, seconds=3.0)
    numbers = run.driver.check(run)
    assert not verdict(run, numbers), numbers
