"""Tracing / profiling harness.

PyTorch port of ``composablestatespacemodels_tpu/utils/profiling.py``
(the reference ships only a stale ScalaMeter bench harness):

* :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace file (Perfetto / ``chrome://tracing``; no TensorBoard
  needed);
* :func:`span` -- a named stretch of the program's host work, recorded in
  the profiler's trace beside the kernels it launched, and a shared null
  context when no profiler is recording;
* :func:`time_fn` -- wall-clock micro-timing with warm-up kept apart from
  the timed calls and the device synchronised before each clock read;
* :func:`benchmark_filter` -- the reference bench matrix (full-filter
  throughput vs particle count, src/bench/scala/ParticleFilter.scala:17-82).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterable

import torch
from torch.autograd import profiler as _autograd_profiler

from .checkpoint import tree_leaves

# the spans the port opens; see :func:`span`
SPANS = ("cssm.online.step", "cssm.filter.setup", "cssm.filter.step",
         "cssm.select", "cssm.host_read", "cssm.pmmh.iter")
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work (host and, where there is a card, CUDA
    activity) and write ``<log_dir>/trace.json``, a Chrome trace.  Yields
    the ``torch.profiler.profile`` object (``key_averages()`` for sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str, args=None):
    """A context that records ``name`` (one of :data:`SPANS`) as a
    ``torch.profiler.record_function`` while a profiler is recording, so
    that the span lands in the profiler's trace, on its clock, with the
    kernels, copies and fills launched inside it; ``args`` (a step's index,
    which host read) becomes the record's argument string.  With no
    profiler recording it enters nothing: one read of the profiler's
    enabled flag and a shared null context, no allocation.  Names are
    fixed strings; a request's index goes in ``args``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(
        name, None if args is None else str(args))


def _sync(value) -> None:
    """Wait until ``value`` is computed: ``torch.cuda.synchronize()`` on each
    CUDA device holding one of its tensors (work on the CPU is done when
    the call returns)."""
    for dev in {x.device for x in tree_leaves(value)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, repeats: int = 5, warmup: int = 2,
            make_args: Callable = None, **kwargs):
    """Median wall-clock seconds of ``fn(*args, **kwargs)``, the device
    synchronised before the clock is read.

    Args:
      repeats: timed calls.
      warmup: untimed calls first (kernel builds, allocator warm-up).
      make_args: optional ``i -> tuple`` of fresh positional args per call
        (e.g. a new generator per call); ``i`` is negative for the warm-up
        calls.

    Returns ``(median_seconds, all_times)``, the times sorted.
    """
    get = make_args if make_args is not None else (lambda i: args)
    for i in range(warmup):
        _sync(fn(*get(-1 - i), **kwargs))
    times = []
    for i in range(repeats):
        a = get(i)
        t0 = time.perf_counter()
        _sync(fn(*a, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times


def benchmark_filter(model, params, data, generator: torch.Generator,
                     particle_counts: Iterable[int] = (1000, 10_000, 100_000),
                     resample="systematic", repeats: int = 3):
    """Full-filter throughput vs N (the reference bench matrix) through
    :func:`~..inference.filter.log_likelihood` on ``generator``'s device,
    two warm-up calls per N.

    Returns a list of ``(n_particles, seconds, particle_steps_per_sec)``,
    ``seconds`` the median of ``repeats`` calls.
    """
    from ..inference.filter import log_likelihood

    n_steps = int(data.ts.shape[0])
    out = []
    for n in particle_counts:
        med, _ = time_fn(log_likelihood, model, params, data, int(n),
                         generator, resample=resample, repeats=repeats)
        out.append((int(n), med, int(n) * n_steps / med))
    return out
