"""The arithmetic of the metrics and of the check, on made-up inputs."""

import math
import types

import pytest
import torch

from cssm_bench import cell, compare, roofline, stats
from cssm_bench.trace import Event, Trace, breakdown, charge_gaps, merged

MS = 1_000_000  # ns


def _trace():
    """A 10 ms window: kernels over [1, 4] and [3, 5] ms (overlapping),
    a copy over [7, 8] ms; host: op A over [0, 5.5] ms holding B over
    [4.5, 5.5] ms, nothing over [5.5, 8], op C over [8, 10] ms."""
    device = [Event("k1", "kernel", 1 * MS, 4 * MS),
              Event("k2", "kernel", 3 * MS, 5 * MS),
              Event("Memcpy", "gpu_memcpy", 7 * MS, 8 * MS)]
    host = [Event("aten::A", "cpu_op", 0, 11 * MS // 2),
            Event("aten::B", "cpu_op", 9 * MS // 2, 11 * MS // 2),
            Event("aten::C", "cpu_op", 8 * MS, 10 * MS)]
    return Trace(0, 10 * MS, device, host)


def test_busy_is_the_union_of_device_intervals():
    t = _trace()
    assert merged(t.device) == [(1 * MS, 5 * MS), (7 * MS, 8 * MS)]
    assert t.busy_s == pytest.approx(5e-3)
    assert t.window_s == pytest.approx(10e-3)


def test_idle_gaps_go_to_the_innermost_host_op():
    gaps = charge_gaps(_trace())
    # [0, 1] ms: A; [5, 7] ms (midpoint 6 ms): no op open; [8, 10] ms: C
    assert gaps == pytest.approx({"aten::A": 1e-3,
                                  "host_outside_any_operation": 2e-3,
                                  "aten::C": 2e-3})
    b = breakdown(_trace())
    assert b["device_ops"][0] == ["k1", pytest.approx(3e-3)]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(5e-3)


def test_idle_share_and_counts_from_the_trace():
    run = types.SimpleNamespace(trace=_trace(), units=[{"traced": True}] * 2,
                                driver=types.SimpleNamespace(
                                    steps_per_unit=lambda r: 5))
    assert cell.metric("device_idle_pct.loglik").read(run) == \
        pytest.approx(50.0)
    assert cell.metric("device_kernels_per_step.loglik").read(run) == \
        pytest.approx(0.2)


def test_roofline_and_whole_step_share():
    assert roofline.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
    n, d = 2 ** 20, 7
    run = types.SimpleNamespace(
        traffic={"n_particles": n}, kind=roofline.DEFAULT,
        config=cell.load_json("configs", "seasonal_poisson_d7"),
        trace=types.SimpleNamespace(window_s=1e-3, device=[1]),
        units=[{"traced": True}], driver=types.SimpleNamespace(
            steps_per_unit=lambda r: 1))
    least = 2 * (d + 1) * n * 4 / 3.35e12
    assert cell.metric("mfu.loglik").read(run) == \
        pytest.approx(100 * least / 1e-3)


def test_k8_least_time_is_bound_by_operations():
    run = types.SimpleNamespace(
        traffic={"n_chains": 256, "n_particles": 100, "n_obs": 1000},
        config=cell.load_json("configs", "negbin_seasonal_d9"),
        kind=roofline.DEFAULT)
    least = cell.metric("K8_roofline.pmmh").least_launch_s(run)
    assert least == pytest.approx(256 * 1000 * 100 * (16 * 9 + 18) / 67e12)


@pytest.mark.parametrize("name,flops", [("seasonal_poisson_d7", 4),
                                        ("negbin_seasonal_d9", 10)])
def test_density_operations_come_from_the_family_file(name, flops):
    assert roofline.density_flops(cell.load_json("configs", name)) == flops


def test_p95_is_over_every_sample():
    assert stats.percentile(list(range(1, 101)), 95.0) == \
        pytest.approx(95.05)
    # one slow observation in twenty moves the p95, as a median of chunk
    # medians would not
    units = [{"t0": 0.0, "t1": 0.010, "traced": False}] * 19 + \
        [{"t0": 0.0, "t1": 0.100, "traced": False}]
    run = types.SimpleNamespace(untraced=lambda: units)
    assert cell.metric("obs_latency_p95_ms").read(run) == pytest.approx(14.5)
    assert cell.metric("obs_latency_p50_ms.online").read(run) == \
        pytest.approx(10.0)


def test_rate_is_all_work_over_the_whole_window():
    units = [{"t0": 0.0, "t1": 1.0}, {"t0": 1.0, "t1": 3.0}]
    run = types.SimpleNamespace(
        untraced=lambda: units, window_s=lambda u: 3.0,
        driver=types.SimpleNamespace(work=lambda r: {"particle_steps": 600}))
    assert cell.metric("particle_steps_per_s").read(run) == 400.0


def test_comparisons_read_noise_units():
    noise = compare.call_noise([torch.zeros(4), torch.full((4,), 0.5)])
    assert noise == pytest.approx(math.sqrt(4 * 0.125))
    nums = compare.calls_vs_reference([1.0, 1.0, 3.0], [1.0, 1.0], 1.0)
    assert nums["ll_max_z"] == pytest.approx(2 / math.sqrt(1.5))
    assert nums["ll_z"] == pytest.approx((2 / 3) / math.sqrt(1 / 3 + 1 / 2))
    gen = torch.Generator().manual_seed(3)
    a, b, c = (torch.randn(4000, generator=gen) for _ in range(3))
    scale = torch.rand(4000, generator=gen) * 10    # spreads pair by pair
    alike = compare.paired_vs_reference(a * scale, b * scale, c * scale)
    assert alike["ll_sign_z"] < 4 and alike["ll_z"] < 4
    assert 0.9 < alike["ll_spread_ratio"] < 1.1
    assert compare.paired_vs_reference(a + 0.5, b, c)["ll_sign_z"] > 8
    assert compare.paired_vs_reference(5 * a, b, c)["ll_spread_ratio"] > 3
    p = torch.rand(4000, generator=gen)
    accepted = torch.rand(4000, generator=gen) < p
    lp = torch.log(p)
    assert compare.accept_z(accepted, lp, torch.zeros(4000)) < 4
    assert compare.accept_z(torch.ones(4000, dtype=torch.bool), lp,
                            torch.zeros(4000)) > 8


def test_summary_rms_is_about_one_when_alike():
    gen = torch.Generator().manual_seed(5)
    d, steps = 2, 400
    base = torch.tensor([2.0, 1.0, 3.0, 0.0, 0.0, -1.0, -1.0, 1.0, 1.0])
    reps = [base + 0.01 * torch.randn(steps, 9, generator=gen)
            for _ in range(2)]
    prog = base + 0.01 * torch.randn(steps, 9, generator=gen)
    assert compare.summaries_vs_replicas(prog, reps, d) < 1.5
    assert compare.summaries_vs_replicas(prog + 0.05, reps, d) > 3


def test_increments_read_back_through_float32_running_sums():
    gen = torch.Generator().manual_seed(11)
    incs = -2.2 + 1e-3 * torch.randn(1000, generator=gen, dtype=torch.float64)
    back = compare.increments(compare.running_float32(incs))
    # a float32 sum near -2200 is kept to about 1e-4, step by step
    assert torch.allclose(back, incs, atol=3e-4)
    assert float(back.sum()) == pytest.approx(
        float(compare.running_float32(incs)[-1]), abs=1e-9)


def test_call_spread_ratio_sees_half_the_particles():
    gen = torch.Generator().manual_seed(13)
    sd = torch.rand(500, generator=gen, dtype=torch.float64) + 0.1

    def calls(m, var_scale):
        return sd * var_scale ** 0.5 * torch.randn(
            m, 500, generator=gen, dtype=torch.float64)

    assert 0.85 < compare.call_spread_ratio(calls(20, 1), calls(4, 1)) < 1.2
    assert 1.7 < compare.call_spread_ratio(calls(20, 2), calls(4, 1)) < 2.4
    assert compare.call_spread_ratio(calls(1, 1), calls(4, 1)) == math.inf


def test_replica_spread_ratio_sees_half_the_particles():
    gen = torch.Generator().manual_seed(17)
    sd = torch.rand(2000, 3, generator=gen, dtype=torch.float64) + 0.1
    base = torch.randn(2000, 3, generator=gen, dtype=torch.float64)

    def run(var_scale):
        return base + sd * var_scale ** 0.5 * torch.randn(
            2000, 3, generator=gen, dtype=torch.float64)

    reps = [run(1) for _ in range(4)]
    assert 0.9 < compare.replica_spread_ratio(run(1), reps) < 1.1
    # (2 + 1/4) / (1 + 1/4) with half the particles
    assert 1.65 < compare.replica_spread_ratio(run(2), reps) < 1.95
    assert 0.9 < compare.replica_spread_ratio(run(1)[:, 0],
                                              [r[:, 0] for r in reps]) < 1.15
