"""The device trace of a traced window, and the arithmetic read from it.

``torch.profiler`` (CUPTI) records every kernel, copy and fill on the card
and every host operation.  The window is a host annotation around the
traced units; each unit ends in a host read, so its device work ends
inside the annotation.  From the events this module works out:

* ``busy_s``: the length of the union of all device activity intervals
  (kernels, copies, fills; overlapping ones counted once) inside the
  window, and ``window_s`` the annotation's length, so that
  ``1 - busy_s / window_s`` is the share of the window in which the card
  ran nothing;
* the idle gaps between device activity, each charged to the innermost
  host operation running at its midpoint on the thread that launched the
  work (``host_outside_any_operation`` where there is none);
* device time by name, kernel counts.
"""

from __future__ import annotations

import dataclasses
import re

WINDOW = "cssm_bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
OUTSIDE = "host_outside_any_operation"


@dataclasses.dataclass
class Event:
    name: str
    kind: str
    start: int      # ns
    end: int        # ns


@dataclasses.dataclass
class Trace:
    start: int
    end: int
    device: list    # Event, DEVICE_KINDS, clipped to the window
    host: list      # Event, HOST_KINDS on the window's thread

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device)) * 1e-9

    def idle_pct(self):
        """``100 (1 - busy_s / window_s)``, or None where no device work
        was traced."""
        if not self.device or self.window_s <= 0.0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, pattern: str = "") -> list:
        rx = re.compile(pattern)
        return [e for e in self.device
                if e.kind == "kernel" and rx.search(e.name)]

    def device_seconds(self, pattern: str) -> float:
        return sum(e.end - e.start for e in self.kernels(pattern)) * 1e-9


def merged(events) -> list:
    """The union of the events' intervals as sorted disjoint ``(s, e)``."""
    out = []
    for s, e in sorted((ev.start, ev.end) for ev in events):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(trace: Trace) -> list:
    """The stretches of the window in which the device ran nothing."""
    out, t = [], trace.start
    for s, e in merged(trace.device):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def charge_gaps(trace: Trace) -> dict:
    """Idle seconds by the innermost host operation at each gap's
    midpoint."""
    spans = sorted(trace.host, key=lambda e: (e.start, -e.end))
    out: dict = {}
    stack, j = [], 0
    for s, e in gaps(trace):
        mid = (s + e) // 2
        while j < len(spans) and spans[j].start <= mid:
            while stack and stack[-1].end <= spans[j].start:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else OUTSIDE
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]+", "_", name)[:64]


def breakdown(trace: Trace, top: int = 10) -> dict:
    dev: dict = {}
    for e in trace.device:
        k = _short(e.name)
        dev[k] = dev.get(k, 0.0) + (e.end - e.start) * 1e-9
    idle = charge_gaps(trace)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in order(dev)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def kind(e) -> str:
    """The event's activity, from its device and name: ``kernel``,
    ``gpu_memcpy``, ``gpu_memset`` or ``gpu_user_annotation`` on the
    device; ``cpu_op``, ``cuda_runtime`` or ``user_annotation`` on the
    host."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def from_profiler(prof) -> Trace:
    """The window of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events
              if e.name() == WINDOW and kind(e) == "user_annotation"]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w = window[0]
    lo, hi, tid = w.start_ns(), w.end_ns(), w.start_thread_id()
    device, host = [], []
    for e in events:
        k = kind(e)
        if k in DEVICE_KINDS and e.name() != WINDOW:
            s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if t > s:
                device.append(Event(e.name(), k, s, t))
        elif (k in HOST_KINDS and e.start_thread_id() == tid
              and e.name() != WINDOW and lo <= e.start_ns() < hi):
            host.append(Event(e.name(), k, e.start_ns(), e.end_ns()))
    return Trace(lo, hi, device, host)
