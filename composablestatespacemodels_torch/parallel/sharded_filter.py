"""Particle-sharded bootstrap filter over a ``torch.distributed`` mesh.

PyTorch port of ``composablestatespacemodels_tpu/parallel/sharded_filter.py``.
Each rank of the mesh's particle axis holds ``local_n = N / S`` particles
as a ``[d, local_n]`` block (global particles ``[idx * local_n, (idx + 1)
* local_n)``) and runs the filter's host loop; per step the only global
synchronisation is

* a max and two sums of weight scalars (``all_reduce``; the log-sum-exp
  update and the ESS), skipped at one shard as the JAX body skips them;
* at a resample, the **distributed systematic resampler**
  (:func:`distributed_systematic_resample_t`): an ``all_gather`` of the
  shards' weight sums gives each shard its global count window
  closed-form, and particle blocks travel a ring of
  ``batch_isend_irecv`` hops until every shard holds its ancestors (one
  hop in the common near-uniform case).  Each hop's local fill is K4
  (``ops/resample_kernel.py::sorted_gather_resample_t``) on the visiting
  block's counts clipped and shifted into this shard's slot frame.  No
  rank ever holds the global cloud.

The resampling positions use one uniform shared by every shard: the
caller passes one ``torch.Generator`` seeded alike on every rank (as every
JAX shard gets the same key), and the shared draws -- the systematic
uniforms, the summaries' picks -- are taken from it in the same order on
every rank.  Each shard's own draws (its initial cloud, its propagation
noise, K5's seeds) come from a generator seeded from a value drawn from
the shared one and folded with the shard index.

Every branch that a collective follows is read from an all-reduced value
(the ESS trigger, the ring's count of unfilled slots), so every rank takes
it alike.  Summaries (``store="summary"``) select exact global order
statistics by the bisection of ``ops/selection.py`` with each round's
counts summed over the shards: 32 small ``all_reduce`` calls, no gather.
The cloud is ``[d, N]`` throughout (the JAX package's ``[N, d]`` body
exists for the TPU and is not ported); ``final_particles`` is a
``DTensor`` sharded on the particle axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..inference import resampling as rs
from ..inference.filter import (FilterResult, PfSummary, _initial_cloud,
                                _interval_levels, _propagate, _step_seeds)
from ..inference.lgcp import _interval_ks
from ..models.model import Model
from ..models.observation import KERNEL_CONSTS
from ..models.params import params_to
from ..models.tree import Tree
from ..ops.resample_kernel import propagate_weights_t, sorted_gather_resample_t
from ..ops.selection import kth_smallest_bits, weighted_quantile_bits
from ..utils.data import TimeSeries
from ..utils.streaming import fold_generator
from .mesh import PARTICLE_AXIS
from .multihost import _BACKENDS


class _Shards:
    """This rank's place on one axis of a mesh, and the collectives over
    that axis's process group."""

    def __init__(self, mesh, axis: str, device: torch.device):
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{mesh.mesh_dim_names})")
        sub = mesh[axis]
        self.group = sub.get_group()
        self.n = sub.size()
        self.idx = sub.get_local_rank()
        backend = dist.get_backend(self.group)
        if (mesh.device_type != device.type
                or backend != _BACKENDS.get(device.type)):
            raise ValueError(
                f"{device.type} tensors on a {mesh.device_type} mesh over "
                f"{backend}: CUDA runs over NCCL, the CPU over gloo")

    def _reduce(self, v: torch.Tensor, op) -> torch.Tensor:
        if self.n == 1:
            return v
        v = v.clone()
        dist.all_reduce(v, op=op, group=self.group)
        return v

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """The sum of ``v`` over the shards (``v`` itself at one shard)."""
        return self._reduce(v, dist.ReduceOp.SUM)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, dist.ReduceOp.MAX)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """Every shard's ``v``, stacked in shard order (run at one shard
        too)."""
        parts = [torch.empty_like(v) for _ in range(self.n)]
        dist.all_gather(parts, v.contiguous(), group=self.group)
        return torch.stack(parts)

    def shift(self, *ts: torch.Tensor):
        """One hop of the ring: send each tensor to shard ``idx + 1`` and
        receive the same from shard ``idx - 1``."""
        nxt = dist.get_global_rank(self.group, (self.idx + 1) % self.n)
        prv = dist.get_global_rank(self.group, (self.idx - 1) % self.n)
        outs = [torch.empty_like(t) for t in ts]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, self.group)
                for t in ts]
               + [dist.P2POp(dist.irecv, o, prv, self.group) for o in outs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


def _left_sum(v: torch.Tensor, k: int) -> torch.Tensor:
    """``v[0] + v[1] + ... + v[k - 1]`` added left to right from 0, so
    every rank and backend holds the same bits."""
    total = torch.zeros((), dtype=v.dtype, device=v.device)
    for i in range(k):
        total = total + v[i]
    return total


# ---------------------------------------------------------------------------
# distributed systematic resampling
# ---------------------------------------------------------------------------


def _counts_in_window(local_cdf: torch.Tensor, s_all: torch.Tensor,
                      u: torch.Tensor, idx: int, n_shards: int):
    """Shard ``idx``'s global cumulative position counts (monotone int32)
    from its local prefix and every shard's weight sum ``s_all``: the sums
    added in shard order, ``ceil(N * cdf - u)`` clipped, the last shard's
    last count forced to N, the running max (K7b on CUDA)."""
    n_total = local_cdf.shape[0] * n_shards
    cdf = (_left_sum(s_all, idx) + local_cdf) / _left_sum(s_all, n_shards)
    counts = torch.clamp(torch.ceil(n_total * cdf - u), 0,
                         n_total).to(torch.int32)
    if idx == n_shards - 1:
        counts[-1] = n_total
    return rs._monotone_counts(counts)


def _window_counts(w_local: torch.Tensor, u: torch.Tensor, sh: _Shards):
    """This shard's global cumulative position counts (window ``[c_prev,
    counts[-1])``) and the previous shard's closing count ``c_prev`` (0 on
    shard 0), as ``_systematic_window_counts`` (``sharded_filter.py:167-200``)
    computes them: the local prefix (K7a on CUDA), the shard sums gathered,
    :func:`_counts_in_window`.  ``c_prev`` is a second gather of the
    closing counts, so windows tile ``[0, N)`` exactly."""
    local_cdf = rs._cumsum(w_local)
    counts = _counts_in_window(local_cdf, sh.gather(local_cdf[-1]), u,
                               sh.idx, sh.n)
    c_prev = torch.zeros((), dtype=torch.int32, device=counts.device)
    if sh.n > 1:    # every shard joins the gather; shard 0 keeps 0
        closing = sh.gather(counts[-1])
        if sh.idx > 0:
            c_prev = closing[sh.idx - 1]
    return counts, c_prev


def _ring_exchange_fill(fill, x_block, counts, c_prev, sh: _Shards):
    """The ring loop (``sharded_filter.py:119-155``): the local fill,
    then hops that pass ``(x_block, counts, c_prev)`` on to the next shard
    and fill from the visiting block, until the all-reduced count of
    unfilled slots is 0 (read on the host after each hop, so every shard
    stops at the same hop) or every block has visited."""
    local_n = counts.shape[0]
    out, filled = fill(torch.zeros_like(x_block),
                       torch.zeros(local_n, dtype=torch.bool,
                                   device=counts.device),
                       x_block, counts, c_prev)
    xb, cbp = x_block, torch.cat([counts, c_prev.view(1)])

    def missing():
        return int(sh.psum(torch.sum(~filled, dtype=torch.int32)))

    hop = 1
    while hop < sh.n and missing() > 0:
        xb, cbp = sh.shift(xb, cbp)
        out, filled = fill(out, filled, xb, cbp[:-1], cbp[-1])
        hop += 1
    return out


def _kernel_fill(sh: _Shards, slots: torch.Tensor):
    """The fill through K4: the visiting block's global counts shifted
    into this shard's slot frame and clipped, its last count set to
    ``local_n`` (it only fabricates ancestors for slots outside the valid
    window, which the mask drops) -- ``sharded_filter.py:262-273``."""
    local_n = slots.shape[0]
    first = sh.idx * local_n

    def fill(out, filled, xb, cb, cp):
        cb_loc = torch.clamp(cb - first, 0, local_n)
        cb_loc[-1] = local_n
        cand = sorted_gather_resample_t(xb, cb_loc)
        valid = (slots >= cp) & (slots < cb[-1])
        out = torch.where((valid & ~filled)[None, :], cand, out)
        return out, filled | valid
    return fill


def _plain_fill(sh: _Shards, slots: torch.Tensor):
    """The fill by search (``sharded_filter.py:275-280``), for testing."""
    local_n = slots.shape[0]

    def fill(out, filled, xb, cb, cp):
        i = torch.searchsorted(cb, slots, right=True)
        valid = (slots >= cp) & (slots < cb[-1])
        cand = xb[:, torch.clamp(i, 0, local_n - 1)]
        out = torch.where((valid & ~filled)[None, :], cand, out)
        return out, filled | valid
    return fill


def _resample_t(x_t: torch.Tensor, w_local: torch.Tensor, u: torch.Tensor,
                sh: _Shards, pallas_fill: Optional[bool] = None):
    """Distributed systematic resampling of the ``[d, local_n]`` block
    with the shared uniform ``u``: the global output slots ``[idx *
    local_n, (idx + 1) * local_n)`` of the systematic sample of the global
    weights.  One shard: the local sample from the same window counts, no
    ring (``sharded_filter.py:231-247``)."""
    local_n = w_local.shape[0]
    counts, c_prev = _window_counts(w_local, u, sh)
    if sh.n == 1:
        if pallas_fill is False:
            return x_t[:, rs._ancestors_from_counts(counts, local_n).long()]
        return sorted_gather_resample_t(x_t, counts)
    slots = sh.idx * local_n + torch.arange(local_n, dtype=torch.int32,
                                            device=x_t.device)
    fill = (_plain_fill if pallas_fill is False else _kernel_fill)(sh, slots)
    return _ring_exchange_fill(fill, x_t, counts, c_prev, sh)


def _all_gather_resample_t(x_t: torch.Tensor, w_local: torch.Tensor,
                           u: torch.Tensor, sh: _Shards):
    """The cross-check route (``resample_comm="allgather"``,
    ``sharded_filter.py:287-308``): gather the weights and the cloud,
    take the global systematic sample, keep this shard's slots."""
    d, local_n = x_t.shape
    n_total = local_n * sh.n
    w_all = sh.gather(w_local).reshape(-1)
    x_all = sh.gather(x_t).permute(1, 0, 2).reshape(d, n_total)
    counts = rs.systematic_counts(w_all, u)          # K1 on CUDA
    first = sh.idx * local_n
    return sorted_gather_resample_t(x_all.contiguous(), counts)[
        :, first:first + local_n]


def _shared_uniform(generator: torch.Generator) -> torch.Tensor:
    return torch.rand((), generator=generator, device=generator.device)


def distributed_systematic_resample_t(x_t_local: torch.Tensor,
                                      w_local: torch.Tensor,
                                      generator: torch.Generator, mesh,
                                      axis: str = PARTICLE_AXIS,
                                      pallas_fill: Optional[bool] = None):
    """Exact global systematic resampling of a particle-sharded cloud, no
    gather of the particle block: call on every rank of ``mesh[axis]``.

    Args:
      x_t_local: ``[d, local_n]`` this shard's particle columns.
      w_local: ``[local_n]`` this shard's unnormalised weights.
      generator: seeded alike on every rank (one shared uniform is drawn).
      mesh: a ``DeviceMesh`` with the axis ``axis``.
      pallas_fill: ``False`` fills by search (the plain fill, a testing
        hook); by default each hop's fill is K4 (its plain version on CPU
        tensors).

    Returns ``[d, local_n]``: the global output slots of this shard
    (semantics of ``resampling.systematic_counts``,
    Resampling.scala:63-72).
    """
    sh = _Shards(mesh, axis, x_t_local.device)
    return _resample_t(x_t_local, w_local, _shared_uniform(generator), sh,
                       pallas_fill)


def distributed_systematic_resample(x_local: torch.Tensor,
                                    w_local: torch.Tensor,
                                    generator: torch.Generator, mesh,
                                    axis: str = PARTICLE_AXIS):
    """:func:`distributed_systematic_resample_t` on an ``[local_n, d]``
    block (``sharded_filter.py:56-116``): the same bits, rows for
    columns."""
    return distributed_systematic_resample_t(
        x_local.T.contiguous(), w_local, generator, mesh, axis).T


# ---------------------------------------------------------------------------
# exact global order statistics without gathering
# ---------------------------------------------------------------------------


def _kth_smallest_sharded(vals: torch.Tensor, ks: torch.Tensor,
                          sh: _Shards) -> torch.Tensor:
    """Exact k-th smallest of each sharded float32 row: the bisection with
    each round's counts summed over the shards."""
    return kth_smallest_bits(vals.to(torch.float32), ks, psum=sh.psum)


def _sharded_weighted_pick(wn: torch.Tensor, u: torch.Tensor, sh: _Shards,
                           n_total: int) -> torch.Tensor:
    """Global index of one particle drawn in proportion to the sharded
    weights ``wn`` by inverse CDF at the shared uniform ``u``
    (``sharded_filter.py:332-346``): the count of global-CDF entries below
    the target is the sum over the shards of the local counts against the
    offset local CDFs."""
    s_all = sh.gather(torch.sum(wn))
    target = u * _left_sum(s_all, sh.n)
    cnt = torch.sum((_left_sum(s_all, sh.idx) + torch.cumsum(wn, 0))
                    < target, dtype=torch.int32)
    return torch.clamp(sh.psum(cnt), 0, n_total - 1)


def _sharded_weighted_summary(model: Model, cols: torch.Tensor,
                              wn: torch.Tensor, mean: torch.Tensor,
                              g: torch.Tensor, interval: float, n_total: int,
                              sh: _Shards):
    """The weighted summary tuple of sharded ``[d + 1, local_n]`` columns
    (state rows, then the eta row): weighted global quantiles by the
    bisection with the masses summed over the shards."""
    d = cols.shape[0] - 1
    ps_s, ps_e = _interval_levels(n_total, interval)
    ps = torch.tensor([list(ps_s)] * d + [list(ps_e)], dtype=torch.float32,
                      device=cols.device)
    sel = weighted_quantile_bits(cols.to(torch.float32), wn, ps,
                                 psum=sh.psum)
    return (model.link(mean @ g), sel[d, 0], sel[d, 1], mean, sel[:d, 0],
            sel[:d, 1])


def _make_save_fn_sharded_t(model: Model, store, interval: float,
                            weighted: bool, generator: torch.Generator,
                            n_steps: int, local_n: int, sh: _Shards):
    """The per-step save ``save(i, t, g, x_t, wn)`` of the sharded ``[d,
    local_n]`` cloud after resampling (``sharded_filter.py:518-576``):
    every rank returns the global step's value.  The draws of
    ``store="path"`` come from the shared generator, for every step at
    once.  The unweighted order-statistic indices wrap mod N as the JAX
    selectors take them (``lgcp._interval_ks``)."""
    n_total = local_n * sh.n
    if store == "ll" or store is None:
        return lambda i, t, g, x_t, wn: None
    device = generator.device
    if store == "path":
        def owned(x_t, j):
            """Global particle ``j``'s column, on every shard."""
            mine = (j // local_n) == sh.idx
            return sh.psum(torch.where(mine, x_t[:, j % local_n], 0.0))

        if weighted:
            u = torch.rand(n_steps, generator=generator, device=device)
            return lambda i, t, g, x_t, wn: owned(
                x_t, _sharded_weighted_pick(wn, u[i], sh, n_total))
        pick = torch.randint(0, n_total, (n_steps,), generator=generator,
                             device=device)
        return lambda i, t, g, x_t, wn: owned(x_t, pick[i])
    if store == "summary":
        d = model.dim
        eta_ks, state_ks = _interval_ks(n_total, interval)
        ks = torch.tensor([list(state_ks)] * d + [list(eta_ks)],
                          dtype=torch.int32, device=device)

        def save(i, t, g, x_t, wn):
            cols = torch.cat([x_t, model.link(g @ x_t)[None]])
            if weighted:
                mean = (sh.psum(torch.sum(wn[None, :] * x_t, dim=1))
                        / sh.psum(torch.sum(wn)))
                return _sharded_weighted_summary(model, cols, wn, mean, g,
                                                 interval, n_total, sh)
            mean = sh.psum(torch.sum(x_t, dim=1)) / n_total
            sel = _kth_smallest_sharded(cols, ks, sh)            # [d + 1, 2]
            return (model.link(mean @ g), sel[d, 0], sel[d, 1], mean,
                    sel[:d, 0], sel[:d, 1])
        return save
    if callable(store):
        # the documented (t, particles [local_n, d], generator) contract
        return lambda i, t, g, x_t, wn: store(t, x_t.T, generator)
    raise ValueError(f"unknown store mode {store!r}")


# ---------------------------------------------------------------------------
# the sharded filter
# ---------------------------------------------------------------------------


def _shard_generator(generator: torch.Generator, sh: _Shards):
    """This shard's own stream: a seed drawn from the shared generator (the
    same draw on every rank), folded with the shard index."""
    base = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    return fold_generator(base, sh.idx, generator.device)


def _local_init(initial_state):
    """A ``DTensor`` cloud as its local ``[local_n, d]`` block."""
    to_local = getattr(initial_state, "to_local", None)
    return initial_state if to_local is None else to_local()


def _sharded_scan_t(model: Model, params: Tree, data: TimeSeries,
                    local_n: int, generator: torch.Generator, sh: _Shards, *,
                    x_init=None, t0=None, store="ll",
                    ess_threshold: Optional[float] = None,
                    interval: float = 0.975, pallas_fill=None,
                    fused_propagate: bool = False,
                    resample_comm: str = "distributed",
                    observed: Optional[list] = None):
    """The filter on this shard (``sharded_filter.py:579-727``): per step
    propagate (torch ops, or K5 + K3 under ``fused_propagate``), weigh
    with the scalar collectives, resample with the distributed systematic
    resampler (or the all-gather route), save.  ``observed`` is the mask
    as a host list.  Returns ``(ll, ll history, ess history, [d, local_n]
    cloud, saved)``."""
    device = generator.device
    params = params_to(params, device)
    sp = model.sde_params(params)
    n_total = local_n * sh.n
    ts, ys, mask = data.ts, data.ys, data.mask
    observed = mask.tolist() if observed is None else observed
    n_steps = len(observed)
    local = _shard_generator(generator, sh)
    x = _initial_cloud(model, params, local, local_n, x_init)
    if x.shape != (model.dim, local_n):
        raise ValueError(f"initial_state gives a {tuple(x.T.shape)} block; "
                         f"this shard holds [{local_n}, {model.dim}]")
    t_start = ts[:1] if t0 is None else torch.tensor(
        [t0], dtype=torch.float32, device=device)
    dts = ts - torch.cat([t_start, ts[:-1]])
    exact = fused_propagate or model.sde.exact
    if exact:
        a, b, q = model.sde.transition_coeffs(sp, dts)           # [T, d]
        cols = [a, b, torch.sqrt(q)]
    design = model.design_vector(ts)                             # [T, d]
    y_safe = torch.where(mask, ys, 0.0)
    family_id = consts = None
    if fused_propagate:
        wspec = model.obs.kernel_log_density()
        if wspec is not None:
            make_consts, family_id = wspec
            cols.append(design)
            c = make_consts(y_safe, model.obs_scale(params))
            consts = torch.zeros((n_steps, KERNEL_CONSTS),
                                 dtype=torch.float32, device=device)
            consts[:, :c.shape[-1]] = c
        seeds = _step_seeds(local, n_steps)      # distinct between shards
    if exact:
        coef = torch.stack(cols, dim=-1).contiguous()            # [T, d, 3|4]
    uniforms = torch.rand(n_steps, generator=generator, device=device)
    save = _make_save_fn_sharded_t(model, store, interval,
                                   ess_threshold is not None, generator,
                                   n_steps, local_n, sh)
    resample = (_resample_t if resample_comm == "distributed"
                else lambda x_, w_, u_, sh_, _: _all_gather_resample_t(
                    x_, w_, u_, sh_))
    scale = model.obs_scale(params)

    uniform_w = torch.full((local_n,), 1.0 / n_total, dtype=torch.float32,
                           device=device)
    wn = uniform_w
    ll = torch.zeros((), dtype=torch.float32, device=device)
    ess = torch.tensor(n_total, dtype=torch.int32, device=device)
    saved, ll_hist, ess_hist = [], [], []
    for i in range(n_steps):
        logw = None
        if fused_propagate:
            x1, logw = propagate_weights_t(
                x, coef[i], None if family_id is None else consts[i],
                seeds[i], family_id)
        else:
            x1 = _propagate(model, params, coef[i] if exact else None,
                            dts[i], x, local)
        do_resample = False
        if observed[i]:
            if logw is None:
                logw = model.obs.log_density(design[i] @ x1, y_safe[i], scale)
            maxw = sh.pmax(torch.amax(logw))
            u = wn * torch.exp(logw - maxw)
            total = sh.psum(torch.sum(u))
            ll = ll + (maxw + torch.log(total))
            wn1 = u / total
            ess = torch.floor(1.0 / sh.psum(torch.sum(wn1 * wn1))).to(
                torch.int32)
            # the all-reduced ESS, read on the host: every shard branches
            # alike
            do_resample = (ess_threshold is None
                           or int(ess) < ess_threshold * n_total)
        else:
            wn1 = wn / sh.psum(torch.sum(wn))
        if do_resample:
            x = resample(x1, wn1, uniforms[i], sh, pallas_fill)
            wn = uniform_w
        else:
            x, wn = x1, wn1
        saved.append(save(i, ts[i], design[i], x, wn))
        ll_hist.append(ll)
        ess_hist.append(ess)
    return ll, torch.stack(ll_hist), torch.stack(ess_hist), x, saved


def _as_sharded(block: torch.Tensor, mesh, axis: str):
    """This shard's ``[local_n, d]`` block as the global cloud, a
    ``DTensor`` sharded on dim 0 over ``mesh[axis]`` (no communication)."""
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(block.contiguous(), mesh[axis], [Shard(0)],
                              run_check=False)


def sharded_bootstrap_filter(model: Model, params: Tree, data: TimeSeries,
                             n_particles: int, generator: torch.Generator,
                             mesh, *,
                             axis: str = PARTICLE_AXIS,
                             t0: Optional[float] = None,
                             initial_state=None,
                             store="summary",
                             ess_threshold: Optional[float] = None,
                             interval: float = 0.975,
                             resample_comm: str = "distributed",
                             transposed: Optional[bool] = None,
                             pallas_fill: Optional[bool] = None,
                             fused_propagate: bool = False) -> FilterResult:
    """:func:`~..inference.filter.bootstrap_filter` with the particle axis
    sharded over ``mesh[axis]``: the same arguments and semantics, run on
    every rank of the mesh with the same ``generator`` seed.

    ``resample_comm``: ``"distributed"`` (the ring, default) or
    ``"allgather"`` (gathers the cloud; for cross-checking).
    ``transposed``: kept for the JAX signature; the cloud is ``[d,
    local_n]`` whatever it says (``True`` with ``"allgather"`` raises, as
    in the JAX package).  ``pallas_fill=False`` fills the ring's hops by
    search instead of K4 (testing).  ``fused_propagate`` propagates with
    K5 (+ K3 for the next log-weights; ``resample=
    "systematic-pallas-fused"`` of ``bootstrap_filter(mesh=)``): exact
    transitions only, statistically (not bitwise) equivalent.  On one
    shard, store ``"ll"``, no ESS trigger and N divisible by 1024 it
    delegates to the single-device fused filter (K1, K2 + K3), as the JAX
    package does.

    ``initial_state``: a ``[d]`` state, this shard's ``[local_n, d]``
    block, or a ``DTensor`` sharded on the particle axis (a previous
    call's ``final_particles``).  Returns a
    :class:`~..inference.filter.FilterResult` whose ``final_particles``
    is a ``DTensor`` of the global ``[N, d]`` cloud, sharded on
    ``mesh[axis]``; every other field is the same on every rank.
    """
    from ..inference.filter import (_check_data_device, _check_scheme,
                                    bootstrap_filter)

    _check_scheme("systematic", store)
    _check_data_device(data, generator)
    model.validate_params(params)
    if resample_comm not in ("distributed", "allgather"):
        raise ValueError(
            f"resample_comm={resample_comm!r}: 'distributed' or 'allgather'")
    if transposed and resample_comm != "distributed":
        raise ValueError("transposed=True requires resample_comm="
                         f"'distributed' (got {resample_comm!r})")
    if fused_propagate and (transposed is False
                            or resample_comm != "distributed"):
        raise ValueError("fused_propagate=True requires the distributed "
                         "resampler on the [d, N] cloud")
    sh = _Shards(mesh, axis, generator.device)
    if n_particles % sh.n:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {sh.n} shards")
    local_n = n_particles // sh.n
    x_init = None if initial_state is None else _local_init(initial_state)
    if (fused_propagate and sh.n == 1 and store in ("ll", None)
            and ess_threshold is None and n_particles % 1024 == 0):
        # one shard has no ring, so the single-device pipeline's fused
        # resample + propagate + next weights in one kernel (K2) serves it
        res = bootstrap_filter(model, params, data, n_particles, generator,
                               resample="systematic-pallas-fused", t0=t0,
                               initial_state=x_init, store="ll",
                               interval=interval)
        return FilterResult(res.ll, res.ll_history, res.ess,
                            _as_sharded(res.final_particles, mesh, axis))
    ll, ll_hist, ess_hist, x, saved = _sharded_scan_t(
        model, params, data, local_n, generator, sh, x_init=x_init, t0=t0,
        store=store, ess_threshold=ess_threshold, interval=interval,
        pallas_fill=pallas_fill, fused_propagate=fused_propagate,
        resample_comm=resample_comm)
    summary = path = None
    if store == "summary":
        summary = PfSummary(data.ts, *(torch.stack(v) for v in zip(*saved)))
    elif store == "path":
        path = torch.stack(saved)
    return FilterResult(ll, ll_hist, ess_hist, _as_sharded(x.T, mesh, axis),
                        summary, path)


def sharded_log_likelihood(model: Model, params: Tree, data: TimeSeries,
                           n_particles: int, generator: torch.Generator,
                           mesh, axis: str = PARTICLE_AXIS,
                           resample_comm: str = "distributed"):
    """PF log marginal likelihood with the particle axis sharded over
    ``mesh[axis]``.  Returns ``(ll, ll_history, ess_history,
    final_particles)``, the final particles a sharded ``DTensor``."""
    res = sharded_bootstrap_filter(model, params, data, n_particles,
                                   generator, mesh, axis=axis, store="ll",
                                   resample_comm=resample_comm)
    return res.ll, res.ll_history, res.ess, res.final_particles
