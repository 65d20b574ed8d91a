"""The plain reference against the system under test, on the CPU: the
model's pieces number for number, and every cell end to end at a small
size, held to the cell's own limits."""

import json
import math

import pytest
import torch

from cssm_bench import cell, system
from cssm_bench.reference.model import RefModel
from cssm_bench.reference.simulate import simulate
from cssm_bench.run import Run, execute
from cssm_bench.tests.conftest import LOGLIK, ONLINE, PMMH, SMALL, small_run, verdict

CONFIGS = [c["name"] for c in cell.benchmark()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_model_pieces_agree(name):
    cfg = cell.load_json("configs", name)
    ref = RefModel(cfg)
    model, params = system.build(cfg)
    assert model.dim == ref.dim
    ts = torch.arange(0.0, 30.0, 0.5)
    assert torch.allclose(model.design_vector(ts).double(),
                          ref.design(ts.double()), atol=2e-5)
    rp = ref.params("cpu")
    a, b, q = model.sde.transition_coeffs(model.sde_params(params), ts[:5])
    ra, rb, rq = ref.transition(rp, ts[:5].double())
    for x, y in ((a, ra), (b, rb), (q, rq)):
        assert torch.allclose(x.double(), y, rtol=1e-5, atol=1e-7)
    m0, c0 = model.sde.initial_moments(model.sde_params(params))
    rm, rc = ref.initial_moments(rp)
    assert torch.allclose(m0.double(), rm, atol=1e-6)
    assert torch.allclose(c0.double(), rc, rtol=1e-5)
    gamma = torch.linspace(-2.0, 3.0, 11)
    y = torch.arange(11.0)
    scale = ref.obs_scale(rp)
    assert torch.allclose(
        model.log_density(params, gamma, y).double(),
        ref.obs.log_density(gamma.double(), y.double(), scale),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_plain_params_read_back_the_tree(name):
    cfg = cell.load_json("configs", name)
    ref = RefModel(cfg)
    _, params = system.build(cfg)
    for got, want in zip(system.plain_params(params), ref.params("cpu")):
        assert (got["scale"] is None) == (want["scale"] is None)
        for f, v in want["sde"].items():
            assert torch.allclose(got["sde"][f], v, atol=1e-6)


def test_simulation_follows_the_seed():
    ref = RefModel(cell.load_json("configs", "seasonal_poisson_d7"))
    a = simulate(ref, 40, 1.0, 2 ** 31 + 9)
    b = simulate(ref, 40, 1.0, 2 ** 31 + 9)
    c = simulate(ref, 40, 1.0, 2 ** 31 + 10)
    assert (a[1] == b[1]).all() and not (a[1] == c[1]).all()
    assert (a[1] >= 0).all() and (a[1] == a[1].round()).all()


@pytest.mark.parametrize("workload", [LOGLIK, ONLINE, PMMH])
def test_cell_agrees_with_reference_at_small_size(workload):
    run = small_run(workload)
    numbers = run.driver.check(run)
    assert verdict(run, numbers), numbers


@pytest.mark.parametrize("workload", [LOGLIK, ONLINE, PMMH])
def test_traced_run_prints_the_contract_line(workload, capsys):
    w = cell.workload(cell.benchmark(), workload)
    traffic = cell.load_json("traffic", w["traffic"])
    traffic.update(SMALL[workload], trace_units=1)
    run = Run(workload, 2 ** 31 + 3, 1.0, True, traffic=traffic)
    assert execute(run, need_devices=False) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(out)
    assert out["correct"] is True and out["device"]["platform"] == "cpu"
    assert out["device"]["busy_s"] == 0.0
    # no device ran, so no device metric is written
    assert not [k for k in out["metrics"] if "idle" in k or "roofline" in k
                or "mfu" in k]
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
