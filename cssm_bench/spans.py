"""The program's spans in a traced window, and what is read inside them.

The port opens ``torch.profiler.record_function`` spans named ``cssm.*``
at its layer boundaries while a profiler records
(``composablestatespacemodels_torch.utils.profiling.span``).
:func:`cssm_bench.trace.from_profiler` keeps them among the window
thread's host events (kind ``user_annotation``), beside the CUDA calls
that launched the card's work (``cudaLaunchKernel``, ``cuLaunchKernel``,
copies, fills) and the profiler's own ``Command Buffer Full`` events, in
which a launch waited on a full launch queue.  The window's own annotation, ``cssm_bench.window``, is not a span
of the program.  From these this module reads, inside the union of a set
of spans:

* :func:`idle_s`: the seconds in which the card ran nothing;
* :func:`host_s`: the host's seconds, less those it was blocked on a full
  launch queue;
* :func:`device_s`: the device seconds of the operations launched there.
  The port issues all its work on the current stream, so the card runs
  it in launch order: the k-th device operation of the window, in start
  order, is the k-th launch.  Where the window's counts of the two
  differ, the pairing is unknown and the answer is None.

Every reader gives None where the trace holds no span of that name: a
program without spans reads nothing.
"""

from __future__ import annotations

import bisect
import re

from .trace import gaps, merged

PREFIX = "cssm."
BLOCKED = re.compile(r"^Command[ _]Buffer[ _]Full$")
LAUNCH = re.compile(r"^(cudaLaunchKernel\w*|cuLaunchKernel\w*"
                    r"|cudaMemcpy\w*Async(_v\d+)?|cudaMemsetAsync(_v\d+)?)$")


def spans(trace, name: str) -> list:
    """The program's spans called ``name`` in the window, in start
    order."""
    if trace is None or not name.startswith(PREFIX):
        return []
    return sorted((e for e in trace.host
                   if e.kind == "user_annotation" and e.name == name),
                  key=lambda e: e.start)


def traced_steps(run) -> int:
    """Steps (filter steps, observations or MH iterations) the traced
    units made."""
    return sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)


def _overlap(a: list, b: list) -> int:
    """The length shared by two sorted lists of disjoint ``(s, e)``."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(trace, within: list):
    """Seconds inside the union of the spans ``within`` in which the card
    ran nothing; None where the window holds no device work."""
    if not within or not trace.device:
        return None
    return _overlap(merged(within), gaps(trace)) * 1e-9


def blocked(trace) -> list:
    """The host's waits on a full launch queue."""
    return [e for e in trace.host if BLOCKED.match(e.name)]


def host_s(trace, within: list):
    """The host's seconds inside the union of the spans ``within``, less
    the part of them in which it was blocked on a full launch queue."""
    if not within:
        return None
    union = merged(within)
    busy = sum(e - s for s, e in union)
    return (busy - _overlap(union, merged(blocked(trace)))) * 1e-9


def launches(trace) -> list:
    """The host's calls that put work on the card, in start order; a call
    recorded inside another (``cuLaunchKernel`` under ``cudaLaunchKernel``)
    counts once."""
    out = []
    for e in sorted((e for e in trace.host if LAUNCH.match(e.name)),
                    key=lambda e: e.start):
        if not out or e.start >= out[-1].end:
            out.append(e)
    return out


def pairs(trace):
    """Each device operation of the window with the call that launched
    it, as ``(launch, operation)`` in order; None where the counts
    differ or the window holds no device work."""
    ops = sorted(trace.device, key=lambda e: e.start)
    calls = launches(trace)
    if not ops or len(ops) != len(calls):
        return None
    return list(zip(calls, ops))


def device_s(trace, within: list):
    """Device seconds of the operations launched inside the union of the
    spans ``within``; None where the launches and the operations cannot
    be paired."""
    if not within:
        return None
    matched = pairs(trace)
    if matched is None:
        return None
    union = merged(within)
    starts = [s for s, _ in union]
    total = 0
    for call, op in matched:
        k = bisect.bisect_right(starts, call.start) - 1
        if k >= 0 and call.start < union[k][1]:
            total += op.end - op.start
    return total * 1e-9


def per_step_ms(run, read, name: str):
    """``read(trace, spans)`` in ms per traced step, over the spans called
    ``name``; None without a trace, its spans or the reading."""
    steps = traced_steps(run)
    within = spans(run.trace, name)
    if not within or not steps:
        return None
    value = read(run.trace, within)
    return None if value is None else 1e3 * value / steps
