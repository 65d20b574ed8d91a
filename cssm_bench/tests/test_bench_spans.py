"""The readings inside the program's spans (``cssm_bench.spans``) and the
metrics that take them, on made-up traces."""

import types

import pytest

from cssm_bench import cell, spans
from cssm_bench.trace import Event, Trace

MS = 1_000_000  # ns
NEW = ("host_stretch_ms.online", "host_reads_per_step.online",
       "selection_device_ms.online", "mh_host_ms_per_iter.pmmh",
       "step_host_ms.loglik")


def _span(name, s, e):
    return Event(name, "user_annotation", s * MS, e * MS)


def _trace(host, device=()):
    return Trace(0, 20 * MS, list(device), list(host))


def _run(trace, units=2, per_unit=1):
    return types.SimpleNamespace(
        trace=trace, units=[{"traced": True}] * units + [{"traced": False}],
        driver=types.SimpleNamespace(steps_per_unit=lambda r: per_unit))


def test_spans_by_name_leave_out_the_window_and_other_events():
    t = _trace([_span("cssm.select", 5, 6), _span("cssm.select", 1, 2),
                _span("cssm_bench.window", 0, 20),
                Event("cssm.select", "cpu_op", 3, 4)])
    assert [e.start for e in spans.spans(t, "cssm.select")] == [1 * MS,
                                                                5 * MS]
    assert spans.spans(t, "cssm_bench.window") == []
    assert spans.spans(None, "cssm.select") == []


def test_idle_inside_nested_spans_counts_once():
    # steps over [0, 8] and [10, 18] ms, each holding a nested span; the
    # card busy over [2, 6] and [12, 19] ms
    host = [_span("cssm.online.step", 0, 8), _span("cssm.select", 1, 7),
            _span("cssm.online.step", 10, 18), _span("cssm.select", 11, 17)]
    device = [Event("k", "kernel", 2 * MS, 6 * MS),
              Event("k", "kernel", 12 * MS, 19 * MS)]
    t = _trace(host, device)
    steps = spans.spans(t, "cssm.online.step")
    assert spans.idle_s(t, steps) == pytest.approx((2 + 2 + 2) * 1e-3)
    both = steps + spans.spans(t, "cssm.select")
    assert spans.idle_s(t, both) == pytest.approx(6e-3)
    assert spans.idle_s(t, []) is None


def test_host_time_less_the_waits_on_a_full_queue():
    host = [_span("cssm.filter.step", 0, 5), _span("cssm.filter.step", 5, 9),
            Event("Command Buffer Full", "cpu_op", 3 * MS, 6 * MS),
            Event("Command Buffer Full", "cpu_op", 12 * MS, 13 * MS)]
    t = _trace(host)
    within = spans.spans(t, "cssm.filter.step")
    assert spans.host_s(t, within) == pytest.approx(6e-3)
    # a wait outside every span takes nothing off
    t2 = _trace(host[:2] + host[3:])
    assert spans.host_s(t2, within) == pytest.approx(9e-3)


def test_order_matching_pairs_the_kth_launch_with_the_kth_operation():
    host = [_span("cssm.select", 2, 6),
            Event("cudaLaunchKernel", "cuda_runtime", 1 * MS, 1 * MS + 10),
            Event("cudaLaunchKernel", "cuda_runtime", 3 * MS, 3 * MS + 10),
            # a launch call recorded inside another counts once
            Event("cuLaunchKernel", "cpu_op", 3 * MS + 2, 3 * MS + 8),
            Event("cudaMemsetAsync", "cuda_runtime", 4 * MS, 4 * MS + 10),
            Event("cudaStreamSynchronize", "cuda_runtime", 5 * MS, 6 * MS),
            Event("cudaMemcpyAsync", "cuda_runtime", 7 * MS, 8 * MS)]
    device = [Event("k0", "kernel", 1 * MS, 2 * MS),
              Event("k1", "kernel", 3 * MS, 5 * MS),
              Event("Memset", "gpu_memset", 5 * MS, 5 * MS + 500_000),
              Event("Memcpy", "gpu_memcpy", 7 * MS, 8 * MS)]
    t = _trace(host, device)
    assert [(c.name, o.name) for c, o in spans.pairs(t)] == [
        ("cudaLaunchKernel", "k0"), ("cudaLaunchKernel", "k1"),
        ("cudaMemsetAsync", "Memset"), ("cudaMemcpyAsync", "Memcpy")]
    within = spans.spans(t, "cssm.select")
    # k1 (2 ms) and the memset (0.5 ms) were launched inside [2, 6] ms
    assert spans.device_s(t, within) == pytest.approx(2.5e-3)
    # one operation more than launches: no pairing, no reading
    extra = _trace(host, device + [Event("k9", "kernel", 9 * MS, 10 * MS)])
    assert spans.pairs(extra) is None
    assert spans.device_s(extra, within) is None
    run = _run(t, units=1, per_unit=2)
    assert cell.metric("selection_device_ms.online").read(run) == \
        pytest.approx(1.25)
    assert cell.metric("selection_device_ms.online").read(
        _run(extra)) is None


def test_new_metrics_read_per_traced_step():
    host = [_span("cssm.online.step", 0, 8), _span("cssm.host_read", 0, 1),
            _span("cssm.host_read", 7, 8), _span("cssm.online.step", 10, 18),
            _span("cssm.host_read", 10, 11), _span("cssm.host_read", 17, 18),
            _span("cssm.pmmh.iter", 0, 4), _span("cssm.filter.step", 0, 3),
            Event("Command_Buffer_Full", "cpu_op", 1 * MS, 2 * MS)]
    device = [Event("k", "kernel", 2 * MS, 6 * MS),
              Event("k", "kernel", 12 * MS, 19 * MS)]
    run = _run(_trace(host, device))
    read = {m: cell.metric(m).read(run) for m in NEW}
    assert read["host_stretch_ms.online"] == pytest.approx(3.0)
    assert read["host_reads_per_step.online"] == pytest.approx(2.0)
    assert read["mh_host_ms_per_iter.pmmh"] == pytest.approx(1.5)
    assert read["step_host_ms.loglik"] == pytest.approx(1.0)
    # no `cssm.select` span in this trace
    assert read["selection_device_ms.online"] is None


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_read_nothing_without_a_trace_or_spans(name):
    assert cell.metric(name).read(_run(None)) is None
    device = [Event("k", "kernel", 2 * MS, 6 * MS)]
    host = [Event("aten::mul", "cpu_op", 1 * MS, 2 * MS),
            Event("cudaLaunchKernel", "cuda_runtime", 1 * MS, 2 * MS),
            Event("Command Buffer Full", "cpu_op", 1 * MS, 2 * MS),
            _span("cssm_bench.window", 0, 20)]
    assert cell.metric(name).read(_run(_trace(host, device))) is None
