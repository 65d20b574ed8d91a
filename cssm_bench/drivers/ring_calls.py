"""Closed-loop log-likelihood calls of the particle-sharded filter, one
rank a card.

The process that ``run.py`` starts is rank 0, on card 0.  Its set-up
builds the port's kernel library with one small call on card 0, then
starts ranks 1 to ``chips - 1``, one process a card (``spawn``), which
meet rank 0 through a file store in a fresh directory under ``TMPDIR``
(no network); the process group's collectives time out after the
traffic's ``group_timeout_s``.  Rank 0 sends every other rank its
commands through a pipe: the cell (configuration, traffic and seed, from
which each rank simulates the same series), a call and its index, the
ring check, stop.  Every command carries the code of the fault planted,
so that a fault reaches every rank alike.  Each unit is one call of
``bootstrap_filter(..., mesh=particle_mesh())`` on every rank, on a
generator folded from ``(seed, call index)`` and seeded alike on every
rank; rank 0 reads its running log-likelihood on the host.

Traffic keys: those of :mod:`.filter_calls` (``n_particles`` in all,
``n_obs``, ``call``, ``warmup_calls``, ``reference_runs``,
``trace_units``), ``ring_log_weight_sd``, ``group_timeout_s``, ``join_s``.

``release`` makes the ring check's resample on every rank, sends stop,
joins the other ranks within ``join_s`` and kills any that overrun.  A
rank that loaded JAX or the JAX package exits with code 3, and rank 0
then refuses to go on.  The check, on rank 0 once the others have exited:

* the log-likelihood cell's numbers (:func:`.filter_calls.check`): every
  call of the window against the reference filter at the same N;
* the ring's own answers: one set of weights at the cell's N, drawn from
  the seed, resampled on every rank through the public
  ``distributed_systematic_resample_t`` with each particle's global index
  as its state, every slot's ancestor gathered to rank 0.  Against the
  systematic sample of the same weights and uniform on float64 cumulative
  weights (the reference's own rule), a slot lies ``e`` slots off where
  its position ``j + u`` lies ``e`` slots outside its ancestor's interval
  ``[N C[a-1], N C[a]]``.  ``ring_slots_wrong``: the count of slots
  farther off than float32 places a position below 2^24
  (:func:`slot_tolerance`: 4 slots at the cell's N).  A count of slots
  whose ancestor differs at all would fail sound runs: at N = 2^24 - 2^12
  the float32 counts round positions above 2^23 to whole slots, and a
  quarter of the slots or more take a neighbour's ancestor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import sys
import tempfile
import time

import torch

from .. import faults, system
from ..cell import fold
from ..reference.model import RefModel
from ..reference.simulate import simulate
from . import filter_calls

SETUP, WARM, CALL, RING, STOP = range(5)
WEIGHTS, UNIFORM = 11, 12
FAULTS = ("state_unchanged", "half_batch", "exchange_left_out",
          "counts_coarsened", "answer_altered")
# a particle's global index as two float32 rows, each exact (K4 moves
# float32 states)
SPLIT = 4096
BLOCK = 1 << 22


def _fault_patch(code: int, op: int, index: int):
    """The fault with code ``code`` (0: none) planted under this rank's
    mesh layer for one command, alike on every rank:

    * ``state_unchanged``: the distributed resample hands back the cloud
      it was given;
    * ``half_batch``: the second half of each shard's resampled cloud a
      copy of its first half;
    * ``exchange_left_out``: the ring keeps its local fill and makes no
      hop, so slots whose ancestors live on another shard keep zeros;
    * ``counts_coarsened``: the window counts rounded to multiples of 4,
      as float32 places them at 2^26 particles;
    * ``answer_altered``: the log-likelihood history of the window's
      second call moved by 5 nats from its middle step on."""
    if not code:
        return contextlib.nullcontext()
    from composablestatespacemodels_torch.parallel import sharded_filter as sf

    fault = FAULTS[code - 1]
    if fault == "state_unchanged":
        return faults.patched(sf, "_resample_t",
                              lambda orig: lambda x_t, *a, **k: x_t)
    if fault == "half_batch":
        return faults.patched(sf, "_resample_t", lambda orig: (
            lambda *a, **k: faults.half_copied(orig(*a, **k))))
    if fault == "exchange_left_out":
        def local_only(orig):
            def fill_here(fill, x_block, counts, c_prev, sh):
                out, _ = fill(torch.zeros_like(x_block),
                              torch.zeros(counts.shape[0], dtype=torch.bool,
                                          device=counts.device),
                              x_block, counts, c_prev)
                return out
            return fill_here
        return faults.patched(sf, "_ring_exchange_fill", local_only)
    if fault == "counts_coarsened":
        def coarse(orig):
            def rounded(local_cdf, s_all, u, idx, n_shards):
                c = orig(local_cdf, s_all, u, idx, n_shards)
                return torch.div(c + 2, 4, rounding_mode="floor") * 4
            return rounded
        return faults.patched(sf, "_counts_in_window", coarse)
    if op != CALL or index != 1:
        return contextlib.nullcontext()

    def altered(orig):
        def moved(*a, **k):
            res = orig(*a, **k)
            hist = res.ll_history.clone()
            hist[hist.shape[0] // 2:] += 5.0
            return dataclasses.replace(res, ll=hist[-1], ll_history=hist)
        return moved
    return faults.patched(sf, "sharded_bootstrap_filter", altered)


class _Job:
    """One rank's part of a cell: the series, the model and the mesh (set
    once the ranks have met)."""

    def __init__(self, payload: dict, mesh, device):
        self.cfg, self.tr = payload["config"], payload["traffic"]
        self.seed, self.mesh, self.device = payload["seed"], mesh, device
        self.ts, self.ys = simulate(RefModel(self.cfg), int(self.tr["n_obs"]),
                                    float(self.cfg["dt"]), self.seed)
        self.model, self.params = system.build(self.cfg)
        self.data = system.series(self.ts, self.ys, device)

    def call(self, purpose: int, index: int):
        gen = system.generator(self.device, fold(self.seed, purpose, index))
        return system.port().bootstrap_filter(
            self.model, self.params, self.data, int(self.tr["n_particles"]),
            gen, mesh=self.mesh, **self.tr.get("call", {}))

    def ring(self, rank: int, world: int):
        """The ring check's resample on this rank; rank 0 gets every
        rank's states ``[2, local_n]`` and weights, in rank order."""
        import torch.distributed as dist

        local_n = int(self.tr["n_particles"]) // world
        w = _weights(self.tr, self.seed, rank, local_n, self.device)
        idx = rank * local_n + torch.arange(local_n, device=self.device)
        x = torch.stack([torch.div(idx, SPLIT, rounding_mode="floor"),
                         idx % SPLIT]).to(torch.float32)
        y = system.port().parallel.distributed_systematic_resample_t(
            x, w, system.generator(self.device, fold(self.seed, UNIFORM)),
            self.mesh)
        ys = [torch.empty_like(y) for _ in range(world)] if rank == 0 else None
        ws = [torch.empty_like(w) for _ in range(world)] if rank == 0 else None
        dist.gather(y.contiguous(), ys, dst=0)
        dist.gather(w, ws, dst=0)
        return ys, ws


def _weights(tr: dict, seed: int, rank: int, local_n: int, device):
    gen = system.generator(device, fold(seed, WEIGHTS, rank))
    return torch.exp(float(tr["ring_log_weight_sd"]) * torch.randn(
        local_n, generator=gen, device=device))


def _rank_main(rank: int, world: int, store: str, device_type: str,
               timeout_s: float, conn) -> None:
    """Ranks 1 and up: meet, then serve rank 0's commands until stop."""
    os.environ["LOCAL_RANK"] = str(rank)
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ct = system.port()
    ct.parallel.initialize_distributed(device_type,
                                       init_method=f"file://{store}",
                                       world_size=world, rank=rank,
                                       timeout=timeout_s)
    mesh = ct.parallel.particle_mesh(device_type)
    device = ct.parallel.multihost.mesh_device(mesh)
    conn.send(rank)
    job = None
    while True:
        op, index, code, payload = conn.recv()
        if op == STOP:
            break
        if op == SETUP:
            job = _Job(payload, mesh, device)
            continue
        with _fault_patch(code, op, index):
            if op == RING:
                job.ring(rank, world)
            else:
                job.call(op, index)
    import torch.distributed as dist
    dist.destroy_process_group()
    from ..run import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"rank {rank} loaded {', '.join(found)}", file=sys.stderr,
              flush=True)
        sys.exit(3)


class Ranks:
    """Ranks 1 to ``world - 1``, one process each, and rank 0's process
    group and particle mesh over all of them."""

    def __init__(self, world: int, device_type: str, timeout_s: float):
        import multiprocessing as mp

        ct = system.port()
        ctx = mp.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="cssm-ring-")
        store = os.path.join(self.dir, "store")
        self.conns, self.procs = [], []
        for rank in range(1, world):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, daemon=True,
                               name=f"cssm-rank-{rank}",
                               args=(rank, world, store, device_type,
                                     timeout_s, theirs))
            proc.start()
            theirs.close()
            self.conns.append(ours)
            self.procs.append(proc)
        ct.parallel.initialize_distributed(device_type,
                                           init_method=f"file://{store}",
                                           world_size=world, rank=0,
                                           timeout=timeout_s)
        self.mesh = ct.parallel.particle_mesh(device_type)
        self.world = world
        for conn in self.conns:   # each rank has met and made its mesh
            if not conn.poll(timeout_s):
                raise RuntimeError(f"a rank did not meet within {timeout_s} s")
            conn.recv()

    def send(self, op: int, index: int = 0, code: int = 0, payload=None):
        for conn in self.conns:
            conn.send((op, index, code, payload))

    def stop(self, join_s: float) -> list:
        """Stop every rank, wait at most ``join_s`` in all, kill those
        still running; their exit codes (None: killed).  Every rank
        destroys its process group, rank 0 with the others: NCCL's
        teardown waits for all of them."""
        import torch.distributed as dist

        self.send(STOP)
        deadline = time.monotonic() + join_s
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        codes = []
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10.0)
                codes.append(None)
            else:
                codes.append(proc.exitcode)
        for conn in self.conns:
            conn.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        return codes


def _code(run) -> int:
    fault = run.state.get("fault")
    return 0 if fault is None else FAULTS.index(fault) + 1


def _on_every_rank(run, op: int, index: int = 0):
    """Send ``op`` to the other ranks and make it here too."""
    code = _code(run)
    run.state["ranks"].send(op, index, code)
    with _fault_patch(code, op, index):
        job = run.state["job"]
        if op == RING:
            return job.ring(0, run.state["ranks"].world)
        return job.call(op, index)


def setup(run) -> None:
    """The series and the model, the kernels built on card 0, the other
    ranks started (unless the caller put running ones in
    ``run.state["ranks"]``), the cell on every rank, the warm-up calls."""
    tr, cfg = run.traffic, run.config
    world = int(run.cell["chips"])
    if int(tr["n_particles"]) % world:
        raise ValueError(f"n_particles {tr['n_particles']} not divisible by "
                         f"{world} ranks")
    payload = {"config": cfg, "traffic": tr, "seed": run.seed}
    job = _Job(payload, None, run.device)
    run.state.update(job=job, ts=job.ts, ys=job.ys, ref=RefModel(cfg))
    run.phase(f"series of {len(job.ts)} simulated, port imported, model "
              f"d = {job.model.dim} built")
    if "ranks" not in run.state:
        if run.device.type == "cuda":
            # one small call builds the kernel library before the other
            # ranks start, so that they load it and build nothing
            system.port().bootstrap_filter(
                job.model, job.params, system.series(
                    job.ts[:2], job.ys[:2], run.device),
                1024, system.generator(run.device, 0), store="ll")
            torch.cuda.synchronize(run.device)
            run.phase("kernel library built on card 0")
        run.state["ranks"] = Ranks(world, run.device.type,
                                   float(tr["group_timeout_s"]))
        run.state["own_ranks"] = True
        run.phase(f"ranks 1-{world - 1} started and met: process group "
                  f"and mesh over {world} ranks")
    ranks = run.state["ranks"]
    ranks.send(SETUP, payload=payload)
    job.mesh = ranks.mesh
    run.phase("cell set up on every rank")
    for k in range(int(tr["warmup_calls"])):
        res = _on_every_rank(run, WARM, k)
        run.phase(f"warm-up call {k}: ll {float(res.ll):.4f}")


def unit(run, i: int) -> dict:
    hist = _on_every_rank(run, CALL, i).ll_history.cpu()
    return {"ll": float(hist[-1]), "running": hist}


work = filter_calls.work
steps_per_unit = filter_calls.steps_per_unit


def release(run) -> None:
    """The ring check's resample on every rank, gathered to rank 0; then
    the other ranks stopped, where this run started them and its caller
    did not ask to keep them (``run.state["keep_ranks"]``)."""
    ys, ws = _on_every_rank(run, RING)
    run.state["ring"] = (_ancestors(torch.cat(ys, dim=1)), torch.cat(ws))
    del ys, ws
    run.state.pop("job")
    if run.state.pop("own_ranks", False) and not run.state.get("keep_ranks"):
        codes = run.state.pop("ranks").stop(float(run.traffic["join_s"]))
        run.log(f"ranks 1-{len(codes)} exit codes {codes}")
        if any(c != 0 for c in codes):
            raise RuntimeError(f"a rank did not end cleanly: exit codes "
                               f"{codes} (None: killed; 3: it loaded JAX)")


def _ancestors(states: torch.Tensor) -> torch.Tensor:
    """Every slot's ancestor from its ``[2, N]`` split global index."""
    return (states[0].to(torch.int64) * SPLIT
            + states[1].to(torch.int64)).to(torch.int32)


def _uniform(run) -> torch.Tensor:
    """The ring check's shared uniform: the first draw of the generator
    every rank was given."""
    gen = system.generator(run.device, fold(run.seed, UNIFORM))
    return torch.rand((), generator=gen, device=run.device).double()


def slot_tolerance(n: int) -> float:
    """How far, in slots, window counts computed in float32 may place a
    slot and still count as right: four of float32's steps at the position
    N, and no more than just below 2^24, the size up to which the port
    states its float32 counts exact (K1 refuses N >= 2^24).  4 slots at
    N >= 2^23, 2^-9 at N = 4096."""
    top = min(int(n), 2 ** 24 - 1)
    return 4.0 * 2.0 ** (math.floor(math.log2(top)) - 23)


def _slot_errors(anc: torch.Tensor, edges: torch.Tensor,
                 u: torch.Tensor) -> tuple:
    """Each slot's distance, in slots, from its position ``j + u`` to the
    interval ``[edges[a - 1], edges[a]]`` of its ancestor ``a`` (``edges``
    the float64 cumulative weights times N, the first interval from 0),
    in blocks of slots: the count of slots farther than
    :func:`slot_tolerance`, and the widest distance."""
    n = anc.shape[0]
    tol = slot_tolerance(n)
    worst, wrong = 0.0, 0
    for lo in range(0, n, BLOCK):
        a = anc[lo:lo + BLOCK].to(torch.int64)
        pos = torch.arange(lo, lo + a.shape[0], dtype=torch.float64,
                           device=anc.device) + u
        ok = (a >= 0) & (a < n)
        a = torch.clamp(a, 0, n - 1)
        upper = edges[a]
        lower = torch.where(a > 0, edges[torch.clamp(a - 1, min=0)], 0.0)
        err = torch.clamp(lower - pos, min=0.0) + torch.clamp(pos - upper,
                                                              min=0.0)
        err = torch.where(ok, err, torch.inf)
        worst = max(worst, float(err.max()))
        wrong += int((err > tol).sum())
    return wrong, worst


def _searched(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The systematic sample's ancestors of normalised cumulative weights
    ``cdf`` (float64): the first ``i`` with ``cdf[i] >= (j + u) / N``, as
    ``reference/pf.py`` takes them."""
    n = cdf.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=cdf.device)
    for lo in range(0, n, BLOCK):
        pos = (torch.arange(lo, min(n, lo + BLOCK), dtype=torch.float64,
                            device=cdf.device) + u) / n
        out[lo:lo + pos.shape[0]] = torch.clamp(
            torch.searchsorted(cdf, pos), max=n - 1).to(torch.int32)
    return out


def _ring_numbers(run, anc: torch.Tensor, w: torch.Tensor,
                  what: str) -> dict:
    u = _uniform(run)
    edges = torch.cumsum(w.double(), 0)
    edges = edges / edges[-1]
    ref = _searched(edges, u)
    differ = int((ref != anc).sum())
    del ref
    edges.mul_(anc.shape[0])
    wrong, worst = _slot_errors(anc, edges, u)
    numbers = {"ring_slots_wrong": wrong}
    world = int(run.cell["chips"])
    local_n = anc.shape[0] // world
    kids = torch.bincount(torch.clamp(anc.to(torch.int64), 0,
                                      anc.shape[0] - 1),
                          minlength=anc.shape[0])
    hist = [torch.bincount(torch.clamp(kids[r * local_n:(r + 1) * local_n],
                                       max=12), minlength=13).tolist()
            for r in range(world)]
    run.log(f"ring {what}: {wrong} slots more than "
            f"{slot_tolerance(anc.shape[0])!r} slots off, the widest "
            f"{worst!r}; {differ} of {anc.shape[0]} with another ancestor "
            f"than the float64 sample's")
    for r, h in enumerate(hist):
        run.log(f"ring {what}: shard {r} offspring counts 0..12+: {h}")
    run.state.setdefault("ring_readings", {})[what] = {
        "slots_differ": differ, "slot_err_max": worst,
        "offspring_by_shard": hist, **numbers}
    return numbers


def check(run) -> dict:
    anc, w = run.state.pop("ring")
    ring = _ring_numbers(run, anc, w, "system")
    del anc
    run.state["ring_weights"] = w
    return {**filter_calls.check(run), **ring}


def control(run) -> dict:
    """The numbers with the reference in bfloat16 in the system's place
    (after :func:`check`): the filter's runs as :func:`.filter_calls.control`
    makes them, and the systematic sample taken on bfloat16 cumulative
    weights."""
    w = run.state["ring_weights"]
    low = torch.cumsum(w.to(torch.bfloat16), 0)
    low = (low / low[-1]).double()
    ring = _ring_numbers(run, _searched(low, _uniform(run)), w, "control")
    return {**filter_calls.control(run), **ring}


@contextlib.contextmanager
def planted(run, fault: str):
    """The fault, by its code, in every command of the run while the block
    lasts (:func:`_fault_patch`)."""
    before = run.state.get("fault")
    run.state["fault"] = fault
    try:
        yield
    finally:
        run.state["fault"] = before

