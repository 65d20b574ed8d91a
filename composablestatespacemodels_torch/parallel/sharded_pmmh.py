"""PMMH over a (chains, particles) mesh.

PyTorch port of ``composablestatespacemodels_tpu/parallel/sharded_pmmh.py``.
Chains run over the mesh's ``chains`` axis, one chain per mesh row (the
reference's ``mapAsync(2)`` chain parallelism,
DetermineParameters.scala:68-69); each chain's particle filter shards its
cloud over the row's ``particles`` axis (:mod:`.sharded_filter`).

Every rank of a row runs the row's MH loop (:func:`..inference.pmmh.pmmh`)
on a generator seeded from a base drawn from the caller's generator and
folded with the chain index, so the shards of a chain draw the same
proposals, uniforms and resampling positions, and chains differ.  A row's
collectives stay in its particle group, so rows advance independently;
the results are gathered over the chain axis at the end, so every rank
returns ``[n_chains, n_iters, ...]``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..inference.pmmh import (_INIT_LL, PmmhResult, PmmhState, flat_prior,
                              pmmh, symmetric_transition)
from ..models.model import Model
from ..models.params import (_leaves, covariance_params, params_to, perturb,
                             perturb_mvn_eigen)
from ..models.tree import Tree, tree_map
from ..utils.checkpoint import (checkpoint_exists, restore_checkpoint,
                                save_checkpoint)
from ..utils.data import TimeSeries
from ..utils.streaming import fold_generator
from .mesh import CHAIN_AXIS, PARTICLE_AXIS
from .sharded_filter import _Shards, _sharded_scan_t


def sharded_initial_state(init_params: Tree, n_chains: int,
                          state_dim: Optional[int] = None) -> PmmhState:
    """Fresh per-chain state: the parameters broadcast over a leading
    ``[n_chains]`` axis, ll = -1e30 so each chain accepts its first
    proposal (PMMH.scala:121).  ``state_dim``: under ``store_state`` the
    latent carry is a ``[n_chains, state_dim]`` zeros slot, which the
    always-accepted first proposal overwrites before it reaches the
    output."""
    device = _leaves(init_params)[0][0].device
    params = tree_map(lambda x: x.expand((n_chains,) + tuple(x.shape))
                      .contiguous(), init_params)
    latent = (() if state_dim is None
              else torch.zeros((n_chains, state_dim), device=device))
    return PmmhState(params,
                     torch.full((n_chains,), _INIT_LL, device=device),
                     torch.zeros(n_chains, dtype=torch.int32, device=device),
                     latent)


def sharded_pmmh(model: Model, init_params: Tree, data: TimeSeries,
                 n_particles: int, generator: torch.Generator, n_iters: int,
                 mesh, *,
                 proposal: Callable,
                 prior: Callable = flat_prior,
                 log_transition: Callable = symmetric_transition,
                 approx: bool = False,
                 store_state: bool = False,
                 init_state: Optional[PmmhState] = None,
                 return_state: bool = False,
                 transposed: Optional[bool] = None):
    """Run ``mesh["chains"].size()`` PMMH chains, each with a
    particle-sharded filter, on every rank of ``mesh`` with ``generator``
    seeded alike.  Result axes: ``[n_chains, n_iters, ...]``, the same on
    every rank.

    Mirrors :func:`..inference.pmmh.pmmh`: ``approx`` re-evaluates the
    current parameters' likelihood every iteration (ApproxPMMH,
    PMMH.scala:128-153); ``store_state`` carries each iteration's latent
    state, one particle drawn uniformly from the chain's final global
    cloud (the owning shard's row summed over the particle axis), so
    ``(params[c, i], states[c, i])`` are joint posterior draws;
    ``init_state`` resumes from a per-chain :class:`PmmhState` (a leading
    ``[n_chains]`` axis on every leaf, see :func:`sharded_initial_state`),
    overriding ``init_params``; ``return_state`` also returns the final
    per-chain state (:func:`sharded_pmmh_monitored`).  ``transposed`` is
    kept for the JAX signature (the cloud is ``[d, N]`` always).
    """
    device = generator.device
    sh = _Shards(mesh, PARTICLE_AXIS, device)
    ch = _Shards(mesh, CHAIN_AXIS, device)
    if n_particles % sh.n:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {sh.n} shards")
    local_n = n_particles // sh.n
    if init_state is None:
        model.validate_params(init_params)
        init_state = sharded_initial_state(
            params_to(init_params, device), ch.n,
            state_dim=model.dim if store_state else None)
    elif store_state and isinstance(init_state.state, tuple):
        # a resumed state from before store_state: a zeros latent carry,
        # emitted until this run's first acceptance
        init_state = dataclasses.replace(
            init_state, state=torch.zeros((ch.n, model.dim), device=device))
    elif not store_state and not isinstance(init_state.state, tuple):
        init_state = dataclasses.replace(init_state, state=())
    row = tree_map(lambda x: x[ch.idx].to(device), init_state)
    base = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=device))
    observed = data.mask.tolist()

    def run(g, p):
        return _sharded_scan_t(model, p, data, local_n, g, sh, store="ll",
                               observed=observed)

    def pf_ll(g, p):
        return run(g, p)[0]

    def pf_ll_state(g, p):
        # one particle of the final (resampled, uniformly weighted) global
        # cloud (filterLlState, ParticleFilter.scala:346-357): a global
        # index from the chain's shared stream, the owner's column summed
        # over the particle axis
        ll, _, _, x, _ = run(g, p)
        j = torch.randint(0, n_particles, (), generator=g, device=device)
        mine = (j // local_n) == sh.idx
        return ll, sh.psum(torch.where(mine, x[:, j % local_n], 0.0))

    res, final = pmmh(fold_generator(base, ch.idx, device), None,
                      pf_ll_state if store_state else pf_ll, proposal,
                      n_iters, prior=prior, log_transition=log_transition,
                      approx=approx, store_state=store_state,
                      init_state=row, return_state=True)
    result = PmmhResult(tree_map(ch.gather, res.params), ch.gather(res.lls),
                        ch.gather(res.accepted),
                        ch.gather(res.states) if store_state else None)
    final = PmmhState(tree_map(ch.gather, final.params), ch.gather(final.ll),
                      ch.gather(final.accepted),
                      ch.gather(final.state) if store_state else ())
    return (result, final) if return_state else result


def sharded_adaptive_pmmh(model: Model, init_params: Tree, data: TimeSeries,
                          n_particles: int, generator: torch.Generator,
                          n_iters: int, mesh, *,
                          pilot_iters: int = 1000,
                          pilot_delta: float = 0.05,
                          burn_in: Optional[int] = None,
                          thin: int = 2,
                          scale: Optional[float] = None,
                          nugget: Optional[float] = None,
                          prior: Callable = flat_prior,
                          log_transition: Callable = symmetric_transition,
                          approx: bool = False,
                          transposed: Optional[bool] = None,
                          return_pilot: bool = False):
    """Two-phase adaptive PMMH over the chain mesh (the mesh tier of
    :func:`..inference.pmmh.adaptive_pmmh`): iid-Gaussian pilot chains on
    every mesh row; the pooled, burned-in, thinned pilot draws of all
    chains estimate one parameter covariance; then each chain restarts
    from its own pilot's last parameters with the shared
    ``perturb_mvn_eigen(scale * cov + nugget * I)`` proposal
    (Parameters.scala:111-123, Utilities.scala:11-18)."""
    pilot = sharded_pmmh(model, init_params, data, n_particles, generator,
                         pilot_iters, mesh, proposal=perturb(pilot_delta),
                         prior=prior, log_transition=log_transition,
                         approx=approx)
    b = pilot_iters // 2 if burn_in is None else burn_in
    kept = pilot.thin(burn_in=b, thin=thin)
    # pool the chains: [n_chains, kept, ...] -> [n_chains * kept, ...]
    pooled = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                      kept.params)
    cov = torch.atleast_2d(covariance_params(pooled))
    dim = cov.shape[0]
    if scale is None:
        scale = 2.38 ** 2 / dim
    if nugget is None:
        nugget = 1e-6 * pilot_delta
    cov = scale * cov + nugget * torch.eye(dim, dtype=cov.dtype,
                                           device=cov.device)
    n_chains = pilot.lls.shape[0]
    device = generator.device
    # ll = -1e30: the main chains accept their first proposal again
    init_state = PmmhState(tree_map(lambda x: x[:, -1], pilot.params),
                           torch.full((n_chains,), _INIT_LL, device=device),
                           torch.zeros(n_chains, dtype=torch.int32,
                                       device=device))
    result = sharded_pmmh(model, init_params, data, n_particles, generator,
                          n_iters, mesh, proposal=perturb_mvn_eigen(cov),
                          prior=prior, log_transition=log_transition,
                          approx=approx, init_state=init_state)
    return (result, pilot) if return_pilot else result


def sharded_pmmh_monitored(generator: torch.Generator, model: Model,
                           init_params: Tree, data: TimeSeries,
                           n_particles: int, n_iters: int, mesh, *,
                           proposal: Callable,
                           chunk_size: int = 1000,
                           prior: Callable = flat_prior,
                           log_transition: Callable = symmetric_transition,
                           approx: bool = False,
                           store_state: bool = False,
                           checkpoint_path: Optional[str] = None,
                           log_every: bool = True,
                           out=None) -> PmmhResult:
    """Mesh chains as a host loop of chunks with acceptance monitoring and
    checkpoint/resume: the mesh tier of
    :func:`..utils.streaming.pmmh_monitored` (monitorStream,
    Streaming.scala:72-94; serialisation Streaming.scala:200-241).

    One base seed is drawn from ``generator``; chunk ``c`` runs
    :func:`sharded_pmmh` on a generator seeded from ``(base, c)``.  Rank 0
    prints the chains' mean acceptance after every chunk and, with
    ``checkpoint_path``, writes the gathered per-chain state, the base and
    the completed chunks (each chunk's draws in
    ``<checkpoint_path>.chunk<c>``), then every rank waits at a barrier.
    A run that finds the checkpoint (as rank 0 sees it) resumes from it on
    every rank and returns the full ``[n_chains, n_iters, ...]`` chain:
    the uninterrupted run's, bit for bit.
    """
    out = sys.stderr if out is None else out
    device = generator.device
    n_chains = mesh[CHAIN_AXIS].size()
    n_chunks = -(-n_iters // chunk_size)
    rank0 = dist.get_rank() == 0
    init_params = params_to(init_params, device)
    state = sharded_initial_state(
        init_params, n_chains, state_dim=model.dim if store_state else None)
    base = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=device))
    start_chunk = 0

    def _chunk_path(c):
        return f"{checkpoint_path}.chunk{c:05d}"

    def _size(c):
        return min(chunk_size, n_iters - c * chunk_size)

    def _template(size):
        def zeros(x):
            return torch.zeros((n_chains, size) + tuple(x.shape[1:]),
                               dtype=x.dtype, device=device)
        return PmmhResult(tree_map(zeros, state.params), zeros(state.ll),
                          zeros(state.accepted),
                          zeros(state.state) if store_state else None)

    pieces = []
    # rank 0's view of the checkpoint decides for every rank
    found = torch.tensor(int(bool(checkpoint_path and rank0
                                  and checkpoint_exists(checkpoint_path))),
                         device=device)
    dist.all_reduce(found)
    if int(found):
        saved = restore_checkpoint(checkpoint_path, {
            "state": state, "key": np.int64(0), "chunk": np.int32(0)})
        state = saved["state"]
        base = int(saved["key"])
        start_chunk = int(saved["chunk"])
        for c in range(start_chunk):
            pieces.append(restore_checkpoint(_chunk_path(c),
                                             _template(_size(c))))
        if log_every and rank0:
            print(f"[sharded-pmmh] resumed from {checkpoint_path} at chunk "
                  f"{start_chunk}/{n_chunks}", file=out)

    for c in range(start_chunk, n_chunks):
        size = _size(c)
        res, state = sharded_pmmh(
            model, init_params, data, n_particles,
            fold_generator(base, c, device), size, mesh, proposal=proposal,
            prior=prior, log_transition=log_transition, approx=approx,
            store_state=store_state, init_state=state, return_state=True)
        pieces.append(res)
        if log_every and rank0:
            total_it = c * chunk_size + size
            acc = float(torch.mean(state.accepted.float())) / total_it
            print(f"[sharded-pmmh] iter {c * chunk_size + size}/{n_iters}  "
                  f"mean acceptance {acc:.3f}  "
                  f"mean ll {float(torch.mean(state.ll)):.2f}", file=out)
        if checkpoint_path:
            if rank0:
                save_checkpoint(_chunk_path(c), res)
                save_checkpoint(checkpoint_path, {
                    "state": state, "key": np.int64(base),
                    "chunk": np.int32(c + 1)})
            dist.barrier()

    def cat(*xs):
        return torch.cat(xs, dim=1)

    return PmmhResult(
        tree_map(cat, *[p.params for p in pieces]),
        cat(*[p.lls for p in pieces]),
        cat(*[p.accepted for p in pieces]),
        cat(*[p.states for p in pieces]) if store_state else None)
