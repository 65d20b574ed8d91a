"""Streaming / online tooling: chunked filters, monitored + checkpointed PMMH.

PyTorch port of ``composablestatespacemodels_tpu/utils/streaming.py``.
The reference expresses online filtering and MCMC experiment plumbing as
Akka Streams stages (Streaming.scala:14-242); here:

* :class:`OnlineFilter` -- an unbounded stream becomes host-fed chunks,
  each filtered by one :func:`~..inference.filter.bootstrap_filter` call
  with the particle cloud carried across chunks (the ``Flow.scan`` of
  ParticleFilter.scala:163-166, without holding the whole stream);
* :func:`pmmh_monitored` -- a long chain runs as a host loop of chunks
  with acceptance-rate monitoring after every chunk (monitorStream,
  Streaming.scala:72-94) and crash-safe checkpoint/resume (the
  serialisation of Streaming.scala:200-241, rebuilt on :mod:`.checkpoint`).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..models.model import Model
from ..models.tree import Tree, tree_map
from .checkpoint import (checkpoint_exists, restore_checkpoint,
                         save_checkpoint, tree_leaves)
from .data import TimeSeries, to_numpy
from .profiling import span

# inference imports utils.data, so the inference imports here are deferred
# into the functions to keep the package's import order free of cycles

class OnlineFilter:
    """Feed observation chunks as they arrive; the filtering state persists.

    Example::

        f = OnlineFilter(model, params, n_particles=10_000,
                         generator=torch.Generator(device="cuda"), t0=0.0)
        for chunk in stream:          # chunk: TimeSeries on that device
            res = f.step(chunk)       # one bootstrap_filter call
        f.ll                          # running log marginal likelihood

    Every chunk draws from ``generator``, so a run is reproducible from
    its seed.  ``mesh``: a ``torch.distributed`` device mesh, to filter
    with the particle axis sharded on every rank (``generator`` seeded
    alike on each); the carried cloud stays a sharded ``DTensor`` between
    chunks.
    """

    def __init__(self, model: Model, params: Tree, n_particles: int,
                 generator: torch.Generator, t0: float, *,
                 resample="systematic", store="summary",
                 interval: float = 0.975, mesh=None):
        model.validate_params(params)
        from ..inference.filter import bootstrap_filter  # deferred
        self._filter = bootstrap_filter
        self.model = model
        self.params = params
        self.n_particles = n_particles
        self.generator = generator
        self.resample = resample
        self.store = store
        self.interval = interval
        self.mesh = mesh
        # the first chunk's filter call draws the initial cloud (on a mesh,
        # each shard its own block)
        self.particles = None
        self.t = torch.tensor(float(t0), device=generator.device)
        self.ll = torch.tensor(0.0, device=generator.device)
        self.n_observed = 0

    def step(self, chunk: TimeSeries):
        """Filter one chunk; returns its
        :class:`~..inference.filter.FilterResult` (summaries are per chunk;
        ``self.ll`` accumulates across chunks)."""
        with span("cssm.online.step", self.n_observed):
            with span("cssm.host_read", "t"):
                t0 = float(self.t)
            res = self._filter(
                self.model, self.params, chunk, self.n_particles,
                self.generator, resample=self.resample, t0=t0,
                initial_state=self.particles, store=self.store,
                interval=self.interval, mesh=self.mesh)
            self.particles = res.final_particles
            self.t = chunk.ts[-1]
            self.ll = self.ll + res.ll
            self.n_observed += int(chunk.ts.shape[0])
        return res


def fold_generator(base: int, index: int, device) -> torch.Generator:
    """A generator seeded from ``(base, index)``, the JAX package's
    ``fold_in(key, index)``: chunk ``index``'s generator here, so a
    resumed run draws what an uninterrupted one drew; a shard's or a
    chain's stream in ``parallel/``."""
    seed = (base ^ (index * 0x9E3779B97F4A7C15)) & (2 ** 64 - 1)
    return torch.Generator(device=device).manual_seed(seed)


def pmmh_monitored(generator: torch.Generator, init_params: Tree,
                   pf_ll: Callable, proposal: Callable, n_iters: int, *,
                   chunk_size: int = 1000,
                   prior: Callable = None,
                   log_transition: Callable = None,
                   approx: bool = False,
                   store_state: bool = False,
                   checkpoint_path: Optional[str] = None,
                   log_every: bool = True,
                   out=None):
    """PMMH as a host loop of chunks with monitoring and checkpointing.

    Prints the running acceptance rate after every chunk (the reference
    prints every 100 iterations, Streaming.monitorStream,
    Streaming.scala:72-94).  One base seed is drawn from ``generator``;
    chunk ``c`` runs :func:`~..inference.pmmh.pmmh` on a generator seeded
    from ``(base, c)`` on ``generator``'s device.  If ``checkpoint_path``
    is given, the chain state (params, ll, accepted, the latent state
    under ``store_state``), the base seed and the completed chunks are
    saved after each chunk (each chunk's draws in
    ``<checkpoint_path>.chunk<c>``), and a run finding the checkpoint
    resumes from it with the saved base and returns the full chain: the
    chain of an uninterrupted run, bit for bit.  ``store_state`` carries
    the sampled latent state through the chain (joint-posterior chains,
    the reference monitorStateStream, Streaming.scala:84-94); ``pf_ll``
    must then return ``(ll, state)``
    (``make_pf_loglik(..., store_state=True)``).
    """
    from ..inference.pmmh import (_NEEDS_STATE, PmmhResult, PmmhState,
                                  flat_prior, initial_state, pmmh,
                                  symmetric_transition)
    from ..models.params import params_to

    prior = flat_prior if prior is None else prior
    log_transition = (symmetric_transition if log_transition is None
                      else log_transition)
    out = sys.stderr if out is None else out
    device = generator.device
    n_chunks = -(-n_iters // chunk_size)
    init_params = params_to(init_params, device)
    state = initial_state(init_params)
    base = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=device))
    start_chunk = 0

    def _chunk_path(c):
        return f"{checkpoint_path}.chunk{c:05d}"

    def _size(c):
        return min(chunk_size, n_iters - c * chunk_size)

    pieces = []
    if checkpoint_path and checkpoint_exists(checkpoint_path):
        latent = ()
        if store_state:
            # the latent state's shape, from one evaluation on a generator
            # of its own (the chain's draws are untouched)
            probe = pf_ll(fold_generator(base, -1, device), init_params)
            if not (isinstance(probe, tuple) and len(probe) == 2):
                raise ValueError(_NEEDS_STATE)
            latent = torch.zeros_like(probe[1])
        template = {"state": PmmhState(state.params, state.ll,
                                       state.accepted, latent),
                    "key": np.int64(0), "chunk": np.int32(0)}
        saved = restore_checkpoint(checkpoint_path, template)
        state = saved["state"]
        base = int(saved["key"])
        start_chunk = int(saved["chunk"])

        def zeros(size):
            return lambda x: torch.zeros((size,) + tuple(x.shape),
                                         dtype=x.dtype, device=x.device)

        # reload the completed chunks, so a resumed run returns the FULL
        # chain
        for c in range(start_chunk):
            z = zeros(_size(c))
            pieces.append(restore_checkpoint(_chunk_path(c), PmmhResult(
                tree_map(z, init_params), z(state.ll), z(state.accepted),
                z(latent) if store_state else None)))
        if log_every:
            print(f"[pmmh] resumed from {checkpoint_path} at chunk "
                  f"{start_chunk}/{n_chunks}", file=out)

    for c in range(start_chunk, n_chunks):
        size = _size(c)
        res, state = pmmh(fold_generator(base, c, device), init_params,
                          pf_ll, proposal, size, prior=prior,
                          log_transition=log_transition, approx=approx,
                          store_state=store_state, init_state=state,
                          return_state=True)
        pieces.append(res)
        if log_every:
            total_it = c * chunk_size + size
            print(f"[pmmh] iter {min((c + 1) * chunk_size, n_iters)}"
                  f"/{n_iters}  acceptance "
                  f"{int(state.accepted) / total_it:.3f}  "
                  f"ll {float(state.ll):.2f}", file=out)
        if checkpoint_path:
            save_checkpoint(_chunk_path(c), res)
            save_checkpoint(checkpoint_path, {
                "state": state, "key": np.int64(base),
                "chunk": np.int32(c + 1)})

    def cat(*xs):
        return torch.cat(xs, dim=0)

    return PmmhResult(
        tree_map(cat, *[p.params for p in pieces]),
        cat(*[p.lls for p in pieces]),
        cat(*[p.accepted for p in pieces]),
        None if not store_state else cat(*[p.states for p in pieces]))


def thin_stream(xs, step: int):
    """Every ``step``-th element of every tensor of ``xs`` (a tensor, a
    tree or a record of them; Streaming.thinStream,
    Streaming.scala:100-105)."""
    return tree_map(lambda a: a[::step], xs)


def ascii_histogram(values, bins: int = 20, width: int = 50,
                    out=None) -> None:
    """ASCII histogram of samples (ParticleFilter.hist,
    ParticleFilter.scala:439-447)."""
    out = sys.stdout if out is None else out
    counts, edges = np.histogram(to_numpy(values), bins=bins)
    peak = max(int(counts.max()), 1)
    for c, lo in zip(counts, edges[:-1]):
        bar = "#" * int(width * c / peak)
        print(f"{lo:10.3f} | {bar} {c}", file=out)


def min_sink(values, initial: float = 0.0) -> float:
    """Running minimum fold over a stream (Streaming.minSink,
    Streaming.scala:197-198).  Keeps the reference's ``0.0`` seed, so an
    all-positive stream returns 0.0 -- a documented quirk."""
    out = initial
    for v in values:
        v = float(v)
        if v < out:
            out = v
    return out


def monitor_stream(records, every: int = 100, out=None):
    """Yield PMMH iteration records unchanged, printing the running
    acceptance rate every ``every`` records (the stateless
    Streaming.monitorStream, Streaming.scala:72-82; records expose
    ``.accepted`` or are ``(.., accepted)`` tuples)."""
    out = sys.stderr if out is None else out
    for i, rec in enumerate(records, start=1):
        if i % every == 0:
            acc = getattr(rec, "accepted", rec[-1] if isinstance(
                rec, (tuple, list)) else rec)
            print(f"Iteration: {i}, accepted: {float(acc) / i}", file=out)
        yield rec


def windowed_mean_params(stacked, window: int):
    """Tumbling-window means of a stacked parameter tree
    (Streaming.calculateMeanParameters, Streaming.scala:62-67): ``n //
    window`` entries (a trailing partial window is dropped, as ``grouped``
    emits only full groups when truncated)."""
    n = tree_leaves(stacked)[0].shape[0]
    k = n // window

    def group_mean(x):
        return torch.mean(
            x[:k * window].reshape((k, window) + tuple(x.shape[1:])), dim=1)

    return tree_map(group_mean, stacked)
