"""Resampling schemes: PyTorch port of
``composablestatespacemodels_tpu/inference/resampling.py``.

Resampling works on *counts*: ``counts[i]`` is the number of resampling
positions strictly below ``cdf[i]``, so particle ``i`` owns output slots
``[counts[i-1], counts[i])`` and the ancestor of slot ``j`` is the first
``i`` with ``counts[i] > j`` (Resampling.scala:63-86).  The gather kernels
(K2, K4 in ``ops/resample_kernel.py``) consume any such counts.

As in the JAX package, the prefix sum and the running max route to the
device kernels (K7a :func:`..ops.scan_kernel.prefix_sum`, K7b
:func:`..ops.scan_kernel.cummax_int32`) for CUDA float32 / int32 ``[N]``
tensors, and the systematic counts to K1 (``resampling.py:40-62, 127-136``
of the JAX package); elsewhere the plain versions run.

The systematic, stratified and multinomial schemes produce counts (the
filter gathers with K4); residual and identity produce ancestor indices.
Every scheme takes the JAX package's TPU branch -- counts, search-free --
on every device, so there is one path: multinomial counts come from one
merged-rank stable sort of ``[u, cdf]``, and the residual fill from those
counts under a random slot permutation.  Each scheme has an inner form
that takes its uniforms (and permutation) explicitly
(:func:`stratified_counts`, :func:`multinomial_counts`,
:func:`_residual_from_draws`), so the tests can feed it the JAX package's
draws; the ``*_indices`` functions draw from a ``torch.Generator``, the
port's counterpart of a key, with ``(generator, weights[, n])`` as the
scheme contract.

The prefix sum accumulates in float64 and rounds each entry to float32.
:func:`_cumsum_ref` replays the kernels' association order
(``csrc/scan.cuh``: a tile of 1024 threads x 4 items, warp-shuffle trees),
so the kernels and their plain versions see the same cdf bits (a float32
prefix moves by ulps with the summation order, and an ulp moves a count by
one at ties -- ``resampling.py:26-63`` of the JAX package).
"""

from __future__ import annotations

import torch

from ..models.tree import tree_map

_THREADS, _ITEMS = 1024, 4   # csrc/scan.cuh: kThreads, kItems
_TILE = _THREADS * _ITEMS


def _warp_tree_sum(v: torch.Tensor) -> torch.Tensor:
    """``__shfl_down_sync`` reduction over the last axis (32): lane l adds
    lane l + o for o = 16, 8, 4, 2, 1; returns lane 0."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """``scan.cuh::block_sum`` over the last axis (1024 threads)."""
    return _warp_tree_sum(_warp_tree_sum(v.unflatten(-1, (32, 32))))


def _warp_inclusive(v: torch.Tensor) -> torch.Tensor:
    """``__shfl_up_sync`` Kogge-Stone inclusive scan over the last axis."""
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    return v


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    """Exclusive from inclusive: lane l takes lane l - 1, lane 0 takes 0."""
    return torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)


def _thread_sums(v: torch.Tensor) -> torch.Tensor:
    """``scan.cuh::thread_sum`` over the last axis of float64 ``v [...,
    tiles * 4096]``: each thread's 4 items summed in order; returns
    ``[..., tiles, 1024]``."""
    v = v.unflatten(-1, (-1, _THREADS, _ITEMS))
    tsum = v[..., 0]
    for k in range(1, _ITEMS):
        tsum = tsum + v[..., k]
    return tsum


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """``scan.cuh::tile_sums``: the block's tree over each tile's thread
    sums; ``[..., tiles]``."""
    return _block_sum(_thread_sums(v))


def _tile_pad(x: torch.Tensor) -> torch.Tensor:
    """``x [..., N]`` in float64, zero-padded to whole tiles."""
    n = x.shape[-1]
    v = torch.zeros(x.shape[:-1] + (-(-n // _TILE) * _TILE,),
                    dtype=torch.float64, device=x.device)
    v[..., :n] = x.to(torch.float64)
    return v


def _cumsum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of float ``x [..., N]`` along the last axis:
    float64 accumulation in the association order of the kernels
    (``csrc/scan.cuh``), each entry rounded to float32.  The plain version
    of K7a and of the prefix of K1, K6 batched and K8; every row is
    scanned on its own."""
    n = x.shape[-1]
    v = _tile_pad(x)
    tiles = v.shape[-1] // _TILE
    tsum = _thread_sums(v)                                # [..., tiles, 1024]
    bsum = _block_sum(tsum)                           # pass 1, [..., tiles]
    v = v.unflatten(-1, (tiles, _THREADS, _ITEMS))
    # the sum of the tiles before tile b: thread k adds tiles k, k + 1024,
    # ... below b in turn, then the block sums the threads' parts
    rounds = -(-tiles // _THREADS)
    padded = torch.zeros(bsum.shape[:-1] + (rounds * _THREADS,),
                         dtype=torch.float64, device=x.device)
    padded[..., :tiles] = bsum
    padded = padded.unflatten(-1, (rounds, _THREADS))[..., None, :, :]
    below = (torch.arange(rounds * _THREADS, device=x.device).view(
        rounds, _THREADS)[None] < torch.arange(
            tiles, device=x.device)[:, None, None])       # [tiles, rounds, T]
    part = torch.where(below[:, 0], padded[..., 0, :], 0.0)
    for r in range(1, rounds):
        part = part + torch.where(below[:, r], padded[..., r, :], 0.0)
    offset = _block_sum(part)                             # [..., tiles]
    # the tile's exclusive scan of the threads' sums
    incl = _warp_inclusive(tsum.unflatten(-1, (32, 32)))
    warp_ex = _shift_right(_warp_inclusive(incl[..., 31]))  # [..., tiles, 32]
    res = warp_ex[..., None] + _shift_right(incl)       # [..., tiles, 32, 32]
    p = offset[..., None] + res.flatten(-2)
    out = torch.empty_like(v)
    for k in range(_ITEMS):
        p = p + v[..., k]
        out[..., k] = p
    return out.flatten(-3)[..., :n].to(torch.float32)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no resampling path for device {x.device}")


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (float64 accumulation, float32 entries): K7a
    for a CUDA float32 ``[N]`` tensor, :func:`_cumsum_ref` elsewhere."""
    _check_device(x)
    if x.device.type == "cuda" and x.dtype == torch.float32 and x.ndim == 1:
        from ..ops.scan_kernel import prefix_sum
        return prefix_sum(x)
    return _cumsum_ref(x)


def _monotone_counts(counts: torch.Tensor) -> torch.Tensor:
    """Exact running max of int32 counts (the float32 cdf of a prefix can
    dip, so ``ceil(n*cdf - u)`` can too; every consumer needs
    nondecreasing counts): K7b for a CUDA int32 ``[N]`` tensor,
    ``torch.cummax`` elsewhere."""
    _check_device(counts)
    if (counts.device.type == "cuda" and counts.dtype == torch.int32
            and counts.ndim == 1):
        from ..ops.scan_kernel import cummax_int32
        return cummax_int32(counts)
    return torch.cummax(counts, dim=0).values


def _monotone_cdf(cdf: torch.Tensor) -> torch.Tensor:
    """Exact running max of a nonnegative float32 cdf, for algorithms that
    need the cdf itself sorted (the merged-rank multinomial counts): K7b
    through an order-preserving int32 bitcast for a CUDA ``[N]`` tensor
    (nonnegative IEEE floats order as their bits), ``torch.cummax``
    elsewhere.  ``resampling.py:66-80`` of the JAX package."""
    _check_device(cdf)
    if (cdf.device.type == "cuda" and cdf.dtype == torch.float32
            and cdf.ndim == 1):
        from ..ops.scan_kernel import cummax_int32
        return cummax_int32(cdf.view(torch.int32)).view(torch.float32)
    return torch.cummax(cdf, dim=-1).values


def _counts_from_cdf(cdf: torch.Tensor, u, n: int) -> torch.Tensor:
    """``cummax(clip(ceil(n*cdf - u), 0, n))`` with ``counts[-1] = n``,
    along the last axis (``u`` broadcasts against ``cdf``).

    ``n*cdf`` and ``- u`` are two separately rounded float32 operations
    (the kernel uses ``__fmul_rn`` / ``__fsub_rn``; a fused multiply-add
    would move a count at ties).  The running max is exact in int32.
    """
    c = torch.clamp(torch.ceil(n * cdf - u), 0, n).to(torch.int32)
    c[..., -1] = n  # guard against cdf[-1] < 1 rounding
    return torch.cummax(c, dim=-1).values


def systematic_counts(weights: torch.Tensor, u, n: int | None = None):
    """Monotone cumulative position counts for systematic resampling,
    from weights and the uniform draw ``u`` (0-d tensor or float).  K1
    for CUDA float32 ``[N]`` weights.  For ``[B, N]`` weights (B chains)
    ``u`` is ``[B]``, ``n`` is N and the counts are ``[B, N]``: K6
    batched (its plain version on the CPU).  Reference semantics:
    Resampling.scala:63-72."""
    m = weights.shape[-1]
    n = m if n is None else n
    _check_device(weights)
    if weights.ndim == 2:
        if n != m:
            raise ValueError(f"[B, N] weights give N = {m} counts per row, "
                             f"got n={n}")
        from ..ops.scan_kernel import systematic_counts_batched
        return systematic_counts_batched(weights, weights.sum(dim=-1), u)
    if (weights.device.type == "cuda" and weights.dtype == torch.float32
            and n == m):
        from ..ops.scan_kernel import systematic_counts_fused
        u = torch.as_tensor(u, dtype=torch.float32, device=weights.device)
        return systematic_counts_fused(weights, weights.sum(), u)
    return _counts_from_cdf(_cumsum(weights / weights.sum()), u, n)


def _stratified_from_cdf(cdf: torch.Tensor, u: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Stratified counts before the running max: ``k + (u[k] < n*c - k)``
    with ``k = floor(n*c)``, clipped to ``[0, n]``, ``counts[-1] = n``."""
    v = n * cdf
    k = torch.floor(v).to(torch.int32)
    k_safe = torch.clamp(k, 0, n - 1).long()
    extra = (u[k_safe] < (v - k)).to(torch.int32)
    counts = torch.clamp(torch.where(k >= n, n, k + extra), 0, n)
    counts[-1] = n
    return counts.to(torch.int32)


def stratified_counts(weights: torch.Tensor, u: torch.Tensor,
                      n: int | None = None):
    """Monotone cumulative position counts for stratified resampling.

    Position j lies in ``[j/n, (j+1)/n)`` at ``(j + u[j]) / n``, so the
    count below cdf value c is ``k + (u[k] < n*c - k)`` with
    ``k = floor(n*c)`` -- elementwise, no search.  ``u`` is the ``[n]``
    uniforms (the JAX package draws them from its key).  On a CUDA device
    the prefix is K7a and the running max K7b.  Reference semantics:
    Resampling.scala:78-86; ``stratified_counts`` (:143) of the JAX
    package.
    """
    n = weights.shape[0] if n is None else n
    return _monotone_counts(_stratified_from_cdf(
        _cumsum(weights / weights.sum()), u, n))


def _ancestors_from_counts(counts: torch.Tensor, n_out: int) -> torch.Tensor:
    """Ancestor indices from nondecreasing counts (``counts[-1] == n_out``)
    along the last axis: scatter particle ``i`` to slot ``counts[i-1]`` for
    every particle with offspring, then forward-fill with a running max.
    Rows of ``[B, N]`` counts (chains) are independent."""
    m = counts.shape[-1]
    lead = counts.shape[:-1]
    offspring = torch.diff(counts, prepend=counts.new_zeros(lead + (1,)))
    starts = counts - offspring
    targets = torch.where(offspring > 0, starts,
                          torch.full_like(starts, n_out)).long()
    seed = torch.zeros(lead + (n_out + 1,), dtype=torch.int32,
                       device=counts.device)
    seed.scatter_reduce_(-1, targets, torch.arange(
        m, dtype=torch.int32, device=counts.device).expand(targets.shape),
        reduce="amax")
    return torch.cummax(seed[..., :n_out], dim=-1).values


def _normalise(w: torch.Tensor) -> torch.Tensor:
    """w / sum(w).  Reference: Resampling.scala:21-24."""
    return w / torch.sum(w)


def _multinomial_from_cdf(cdf: torch.Tensor, u: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Multinomial counts before the running max, from a sorted cdf ``[m]``
    and the ``[n]`` uniform positions: in the stable sort of ``[u, cdf]``
    the merged rank of ``cdf[i]`` is ``#(u <= cdf[i]) + i`` (ties put the
    position first, the ``side='left'`` lookup), so ``counts[i] =
    rank(cdf[i]) - i``; clipped to ``[0, n]``, ``counts[-1] = n``."""
    m = cdf.shape[0]
    order = torch.sort(torch.cat([u, cdf]), stable=True).indices
    rank = torch.empty(n + m, dtype=torch.int32, device=cdf.device)
    rank[order] = torch.arange(n + m, dtype=torch.int32, device=cdf.device)
    counts = torch.clamp(rank[n:] - torch.arange(
        m, dtype=torch.int32, device=cdf.device), 0, n)
    counts[-1] = n
    return counts


def multinomial_counts(weights: torch.Tensor, u: torch.Tensor,
                       n: int | None = None) -> torch.Tensor:
    """Monotone cumulative position counts for multinomial resampling from
    the ``[n]`` iid uniform positions ``u``: one merged-rank stable sort,
    no search.  The float32 prefix can dip by an ulp, and the rank identity
    needs a sorted cdf, so the cdf is monotonised first (K7b through
    :func:`_monotone_cdf`), then the counts (K7b).  The same multiset of
    ancestors as a per-position lookup (Resampling.scala:92-96), produced
    in sorted order.  ``multinomial_counts`` (:177) of the JAX package."""
    n = weights.shape[0] if n is None else n
    cdf = _monotone_cdf(_cumsum(_normalise(weights)))
    return _monotone_counts(_multinomial_from_cdf(cdf, u, n))


def _iid_draws_sorted_permuted(weights: torch.Tensor, u: torch.Tensor,
                               perm: torch.Tensor) -> torch.Tensor:
    """n iid draws from ``weights``, search-free: the multinomial ancestors
    (sorted) under the random slot permutation ``perm``, which restores
    exchangeability, so any prefix is an iid sample too
    (``_iid_draws_sorted_permuted`` :233 of the JAX package)."""
    n = u.shape[0]
    return _ancestors_from_counts(multinomial_counts(weights, u, n), n)[perm]


def _residual_from_draws(weights: torch.Tensor, u: torch.Tensor,
                         perm: torch.Tensor) -> torch.Tensor:
    """Residual resampling with fixed shapes, its draws given: particle i
    is copied ``floor(n w_i)`` times into the first ``K = sum floor(n w)``
    slots, and the slots from K on take iid draws from the residual weights
    (Resampling.scala:130-146; ``residual_indices`` :250 of the JAX
    package, its TPU branch)."""
    n = u.shape[0]
    wn = _normalise(weights)
    ki = torch.floor(wn * n).to(torch.int32)
    # slot j < K holds the first i with cumsum(ki)[i] > j
    det = _ancestors_from_counts(torch.cumsum(ki, 0).to(torch.int32), n)
    residual = torch.clamp(wn * n - ki, min=0.0)
    # uniform residual weights where the residual mass is 0 (every slot
    # is then deterministic)
    safe = torch.where(torch.sum(residual) > 0, residual,
                       torch.ones_like(residual))
    multi = _iid_draws_sorted_permuted(safe, u, perm)
    slot = torch.arange(n, device=weights.device)
    return torch.where(slot < torch.sum(ki), det, multi)


def _uniforms(generator: torch.Generator, shape, weights: torch.Tensor):
    return torch.rand(shape, generator=generator, device=weights.device)


def systematic_indices(generator, weights, n: int | None = None):
    """Systematic resampling ancestors (Resampling.scala:63-72)."""
    n = weights.shape[0] if n is None else n
    return _ancestors_from_counts(
        systematic_counts(weights, _uniforms(generator, (), weights), n), n)


def stratified_indices(generator, weights, n: int | None = None):
    """Stratified resampling ancestors (Resampling.scala:78-86)."""
    n = weights.shape[0] if n is None else n
    return _ancestors_from_counts(
        stratified_counts(weights, _uniforms(generator, (n,), weights), n), n)


def multinomial_indices(generator, weights, n: int | None = None):
    """Multinomial resampling ancestors (Resampling.scala:92-96), sorted:
    ancestors are exchangeable, so order is irrelevant to every consumer."""
    n = weights.shape[0] if n is None else n
    return _ancestors_from_counts(multinomial_counts(
        weights, _uniforms(generator, (n,), weights), n), n)


def residual_indices(generator, weights, n: int | None = None):
    """Residual resampling ancestors (Resampling.scala:130-146)."""
    n = weights.shape[0] if n is None else n
    u = _uniforms(generator, (n,), weights)
    perm = torch.randperm(n, generator=generator, device=weights.device)
    return _residual_from_draws(weights, u, perm)


def identity_indices(generator, weights, n: int | None = None):
    """No resampling.  Reference: Resampling.scala:29."""
    m = weights.shape[0]
    n = m if n is None else n
    return torch.arange(n, device=weights.device) % m


_SCHEMES = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
    "residual": residual_indices,
    "identity": identity_indices,
}


def get_scheme(name_or_fn):
    """The ``(generator, weights) -> indices`` function of a scheme name,
    or the callable itself."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _SCHEMES[name_or_fn]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {name_or_fn!r}; "
            f"choose from {sorted(_SCHEMES)}") from None


def _take(xs, idx):
    return tree_map(lambda x: x[idx], xs)


def _leading(xs) -> int:
    """The leading size of the first tensor of a tree."""
    sizes = []
    tree_map(lambda x: sizes.append(x.shape[0]), xs)
    return sizes[0]


def resample(generator, particles, weights, scheme="systematic"):
    """Gather a resampled particle set: a tensor, or a tree of tensors with
    leading axis N."""
    return _take(particles, get_scheme(scheme)(generator, weights))


def exp_normalise(logw: torch.Tensor) -> torch.Tensor:
    """Log weights -> normalised linear weights without overflow
    (Resampling.scala:102-108)."""
    w = torch.exp(logw - torch.max(logw))
    return w / torch.sum(w)


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """floor(1 / sum(w_hat^2)) from unnormalised linear weights
    (ParticleFilter.scala:431-434)."""
    wn = _normalise(weights)
    return torch.floor(1.0 / torch.sum(wn * wn)).to(torch.int32)


def sample_one(generator, xs):
    """One element, uniformly, along the leading axis
    (Resampling.sampleOne, Resampling.scala:151-154)."""
    i = torch.randint(0, _leading(xs), (), generator=generator,
                      device=generator.device)
    return _take(xs, i)


def sample_many(generator, n: int, xs):
    """n elements uniformly WITHOUT replacement (Resampling.sampleMany,
    Resampling.scala:159-162)."""
    idx = torch.randperm(_leading(xs), generator=generator,
                         device=generator.device)[:n]
    return _take(xs, idx)


def posterior_sample(generator, stacked, n: int):
    """n draws with replacement from a stacked posterior tree
    (Streaming.createDist, Streaming.scala:170-174)."""
    idx = torch.randint(0, _leading(stacked), (n,), generator=generator,
                        device=generator.device)
    return _take(stacked, idx)
