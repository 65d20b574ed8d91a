"""The kernels on the ``[d, N]`` cloud: K2 + K3, the fused resample, exact
affine-Gaussian propagate and next-step log-weights; K4, the plain
resampling gather; K5 (+ K3), the standalone propagate with optional
log-weights.

Replaces ``composablestatespacemodels_tpu/ops/resample_kernel.py``'s
``sorted_gather_resample_propagate_t`` (:667) and the
``kernel_log_density`` hooks of its seven pointwise observation families
(K3, ``csrc/obs_density.cuh``) with the CUDA kernel in
``csrc/resample_propagate.cu``::

    anc_j   = first i with counts[i] > j
    y[:, j] = a * x[:, anc_j] + b + s * z_j          z ~ N(0, 1)
    logw[j] = fn(sum_r design_r * y[r, j], consts)

``coef`` is ``[d, 4]`` with columns (a, b, sqrt(q), design); ``consts``
the family's per-step constants (``make_consts``, padded to
``KERNEL_CONSTS``); ``family_id`` one of the ids of
``models/observation.py`` (Gaussian 0, Poisson 1, ZeroInflatedPoisson 2,
NegativeBinomial 3, Bernoulli 4, StudentsT 5, Beta 6); ``seed`` the
per-step int32 Philox key.
The log-weights are a separate ``[N]`` output (the TPU kernel wrote them
into a spare padding row of the cloud, an alignment workaround).

On the H100 the kernel is memory-bound: at d = 7, N = 2^20 it reads
~28 MiB of cloud (+4 MiB counts) and writes ~32 MiB per step.  Its
ancestors come from a merge of the counts with the output slots (merge
path, ``csrc/ancestor.cuh``): each block of 256 threads owns 2048 merged
positions, stages its counts in shared memory and expands its slots'
ancestors there, so no thread searches global memory for its ancestor.
K4 finds its ancestors the same way.  :func:`merge_path_ancestors_ref`
replays that arithmetic in plain PyTorch (the CPU tests hold it to
:func:`_ancestors_from_counts` and to the JAX K4); no CUDA path calls
it.

The noise is Philox4x32-10 keyed by the seed with the column index as the
counter (``csrc/philox.cuh``).  :func:`philox4x32_10` computes the same
bits with int64 tensor ops (32-bit products in 16-bit halves), so the
plain version :func:`resample_propagate_ref` draws identical normals and
the card can compare kernel and plain version value by value.

K4 (:func:`sorted_gather_resample_t`, replacing ``sorted_gather_resample_t``
:616, ``csrc/gather.cu``) is K2 without the propagate: ``y[:, j] =
x[:, anc_j]``, bit for bit ``x[:, _ancestors_from_counts(counts, N)]``,
its ancestors by K2's merge path, then each row of a thread's eight
columns loaded before any is stored.
K5 (:func:`propagate_weights_t`, replacing ``propagate_weights_t`` :756,
``csrc/propagate_weights.cu``) is K2 without the resample: ``y = a * x +
b + s * z`` with the same Philox noise, plus the log-weights when a family
is given.  The plain version of K2 is the plain K4 followed by the plain
K5.

Each wrapper launches its kernel for CUDA tensors and raises for any
device it cannot serve; for CPU tensors (the tests) it computes its
``*_ref`` plain version.  Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from ..inference.resampling import _ancestors_from_counts
from ..models.observation import _KERNEL_FNS, kernel_fn
from . import _build

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for ``a`` in [0, 2^32): the
    product is assembled from the 16-bit halves of ``m`` so no int64 step
    overflows."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)        # < 2^48 each
    s = p_lo + ((p_hi & 0xFFFF) << 16)                  # < 2^49
    return ((p_hi >> 16) + (s >> 32)) & _MASK32, s & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words: ``ctr`` four
    words, ``key`` two; returns the four output words (csrc/philox.cuh)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(a: torch.Tensor, b: torch.Tensor):
    """Two normals from two words: 24-bit uniforms, u1 in (0, 1]."""
    u1 = (a >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    theta = 6.28318530717958 * ((b >> 8).float() * 2.0 ** -24)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(theta), r * torch.sin(theta)


def philox_normals(seed: torch.Tensor, d: int, n: int, c2=0,
                   c3=0) -> torch.Tensor:
    """The kernels' normals ``z [..., d, n]``: column j, rows 4k..4k+3
    come from Philox counter (j, k, c2, c3) under key (seed, 0).  K2 and
    K5 use c2 = c3 = 0; K8 puts the step in c2 and the chain in c3, which
    may be int64 tensors broadcasting to the leading axes."""
    j = torch.arange(n, dtype=torch.int64, device=seed.device)
    c2 = torch.as_tensor(c2, dtype=torch.int64, device=seed.device)[..., None]
    c3 = torch.as_tensor(c3, dtype=torch.int64, device=seed.device)[..., None]
    j, c2, c3 = torch.broadcast_tensors(j, c2, c3)
    k0 = seed.reshape(()).to(torch.int64) & _MASK32
    rows = []
    for k in range((d + 3) // 4):
        w0, w1, w2, w3 = philox4x32_10((j, torch.full_like(j, k), c2, c3),
                                       (k0, 0))
        rows += [*_box_muller(w0, w1), *_box_muller(w2, w3)]
    return torch.stack(rows[:d], dim=-2)


# csrc/ancestor.cuh: kMergeThreads, kMergeItems
MERGE_THREADS, MERGE_ITEMS = 256, 8


def merge_split_ref(counts: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``ancestor.cuh::merge_split`` for each merged position in ``d``
    (int64): the number of particles ``i`` with ``clamp(counts[i], 0, n) +
    i < d``, found as the device finds it, 32 probes a round."""
    n = counts.shape[0]
    c = counts.long().clamp(0, n)
    lo = (d - n).clamp(min=0)
    hi = d.clamp(max=n)
    lanes = torch.arange(1, 33, device=counts.device)
    while bool((hi > lo).any()):
        live = hi > lo
        step = (hi - lo + 31) // 32
        p = lo[:, None] + lanes * step[:, None] - 1
        valid = live[:, None] & (p < hi[:, None])
        pc = p.clamp(0, n - 1)
        below = valid & (c[pc] + pc < d[:, None])
        keep = lo + below.sum(dim=1) * step
        hi = torch.where(live, torch.minimum(hi, keep + step - 1), hi)
        lo = torch.where(live, keep, lo)
    return lo


def merge_path_ancestors_ref(counts: torch.Tensor,
                             threads: int = MERGE_THREADS,
                             items: int = MERGE_ITEMS) -> torch.Tensor:
    """K2's ancestors as ``ancestor.cuh::merge_path_ancestors`` finds them,
    for blocks of ``threads`` threads that walk ``items`` merged positions
    each: int64 ``[N]``, equal to ``_ancestors_from_counts(counts, N)`` for
    nondecreasing counts with ``counts[-1] == N``.  Particle i goes before
    slot j in the merge when ``counts[i] <= j``; each block's split comes
    from :func:`merge_split_ref`, each thread's from a search of the
    block's counts (the same co-rank), then every thread walks its
    positions within its block's bounds."""
    n = counts.shape[0]
    dev = counts.device
    c = counts.long().clamp(0, n)
    tile = threads * items
    blocks = -(-2 * n // tile)
    d0 = torch.arange(blocks, device=dev) * tile
    d1 = (d0 + tile).clamp(max=2 * n)
    i0, i1 = merge_split_ref(counts, d0), merge_split_ref(counts, d1)
    j0, j1 = d0 - i0, d1 - i1
    # every thread's start: its co-rank in the block's counts
    dd = (d0[:, None] + torch.arange(threads, device=dev) * items).flatten()
    blk = torch.arange(blocks, device=dev).repeat_interleave(threads)
    ia = torch.searchsorted(c + torch.arange(n, device=dev), dd)
    jb = dd - ia
    end = torch.minimum(dd + items, d1[blk])
    anc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for t in range(items):
        live = dd + t < end
        take = live & (ia < i1[blk]) & (
            (jb >= j1[blk]) | (c[ia.clamp(max=n - 1)] <= jb))
        emit = live & ~take
        anc[jb[emit]] = ia[emit].clamp(max=n - 1)
        ia = ia + take.long()
        jb = jb + emit.long()
    return anc


def _check(t: torch.Tensor, dtype, shape, name: str, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_weighting(consts, seed, family_id, dev) -> None:
    if family_id is not None:
        if family_id not in _KERNEL_FNS:
            raise ValueError(f"no K3 device function for family {family_id}")
        if (consts.device != dev or consts.dtype != torch.float32
                or consts.ndim != 1 or not consts.is_contiguous()):
            raise ValueError("consts must be a contiguous float32 row on "
                             f"{dev}")
    if seed.device != dev or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"seed must be one int32 element on {dev}")


def sorted_gather_resample_t_ref(x: torch.Tensor,
                                 counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: ``x[:, _ancestors_from_counts(counts,
    N)]``."""
    return x[:, _ancestors_from_counts(counts, x.shape[1]).long()]


def sorted_gather_resample_t(x: torch.Tensor,
                             counts: torch.Tensor) -> torch.Tensor:
    """``y[:, j] = x[:, first i with counts[i] > j]`` on ``x [d, N]`` for
    nondecreasing int32 ``counts [N]`` with ``counts[-1] == N``."""
    if x.device.type == "cpu":
        return sorted_gather_resample_t_ref(x, counts)
    if x.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {x.device}")
    d, n = x.shape
    if not 0 < n < 2 ** 31:
        raise ValueError(f"N={n} outside (0, 2^31): K4's ancestors are "
                         "int32")
    _check(x, torch.float32, (d, n), "x", x.device)
    _check(counts, torch.int32, (n,), "counts", x.device)
    y = torch.empty_like(x)
    err = _build.lib().cssm_gather(x.data_ptr(), counts.data_ptr(),
                                   y.data_ptr(), d, n, x.device.index,
                                   _build.cuda_stream(x.device))
    _build.check(err, "cssm_gather")
    sorted_gather_resample_t.launches += 1
    return y


sorted_gather_resample_t.launches = 0


def sorted_gather_resample(x: torch.Tensor,
                           counts: torch.Tensor) -> torch.Tensor:
    """``[N, d]`` boundary wrapper of :func:`sorted_gather_resample_t`
    (``sorted_gather_resample`` :835): ``x[_ancestors_from_counts(counts,
    N)]``."""
    return sorted_gather_resample_t(x.T.contiguous(), counts).T


def propagate_weights_t_ref(x: torch.Tensor, coef: torch.Tensor,
                            consts, seed: torch.Tensor, family_id):
    """Plain PyTorch version of K5 (+ K3), in the kernel's operation
    order."""
    d, n = x.shape
    z = philox_normals(seed, d, n)
    a, b, s = (coef[:, k, None] for k in range(3))
    y = a * x + b + s * z
    if family_id is None:
        return y, None
    design = coef[:, 3]
    gamma = design[0] * y[0]
    for r in range(1, d):
        gamma = gamma + design[r] * y[r]
    return y, kernel_fn(family_id)(gamma, consts)


def propagate_weights_t(x: torch.Tensor, coef: torch.Tensor, consts,
                        seed: torch.Tensor, family_id=None):
    """Propagate ``x [d, N]`` with ``coef`` -- ``[d, 3]`` (a, b, sqrt(q))
    or, with a family, ``[d, 4]`` (+ design) -- and the Philox normals of
    ``seed``; returns ``(y [d, N], logw [N])``, ``logw`` None without a
    family (``family_id`` None, ``consts`` unused)."""
    if x.device.type == "cpu":
        return propagate_weights_t_ref(x, coef, consts, seed, family_id)
    if x.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {x.device}")
    d, n = x.shape
    dev = x.device
    _check(x, torch.float32, (d, n), "x", dev)
    _check(coef, torch.float32, (d, 3 if family_id is None else 4), "coef",
           dev)
    _check_weighting(consts, seed, family_id, dev)
    y = torch.empty_like(x)
    logw = (None if family_id is None
            else torch.empty(n, dtype=torch.float32, device=dev))
    err = _build.lib().cssm_propagate_weights(
        x.data_ptr(), coef.data_ptr(),
        None if family_id is None else consts.data_ptr(), seed.data_ptr(),
        y.data_ptr(), None if logw is None else logw.data_ptr(), d, n,
        -1 if family_id is None else family_id, dev.index,
        _build.cuda_stream(dev))
    _build.check(err, "cssm_propagate_weights")
    propagate_weights_t.launches += 1
    return y, logw


propagate_weights_t.launches = 0


def resample_propagate_ref(x: torch.Tensor, counts: torch.Tensor,
                           coef: torch.Tensor, consts: torch.Tensor,
                           seed: torch.Tensor, family_id: int):
    """Plain PyTorch version of K2 + K3: the plain K4, then the plain K5."""
    return propagate_weights_t_ref(sorted_gather_resample_t_ref(x, counts),
                                   coef, consts, seed, family_id)


def resample_propagate(x: torch.Tensor, counts: torch.Tensor,
                       coef: torch.Tensor, consts: torch.Tensor,
                       seed: torch.Tensor, family_id: int):
    """Resample ``x [d, N]`` by ``counts``, propagate with ``coef [d, 4]``
    and weight with family ``family_id``; returns ``(y [d, N], logw [N])``."""
    if x.device.type == "cpu":
        return resample_propagate_ref(x, counts, coef, consts, seed,
                                      family_id)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    d, n = x.shape
    if not 0 < n < 2 ** 31:
        raise ValueError(f"N={n} outside (0, 2^31): K2's ancestors are "
                         "int32")
    dev = x.device
    _check(x, torch.float32, (d, n), "x", dev)
    _check(counts, torch.int32, (n,), "counts", dev)
    _check(coef, torch.float32, (d, 4), "coef", dev)
    _check_weighting(consts, seed, family_id, dev)
    y = torch.empty_like(x)
    logw = torch.empty(n, dtype=torch.float32, device=dev)
    err = _build.lib().cssm_resample_propagate(
        x.data_ptr(), counts.data_ptr(), coef.data_ptr(), consts.data_ptr(),
        seed.data_ptr(), y.data_ptr(), logw.data_ptr(), d, n, family_id,
        dev.index, _build.cuda_stream(dev))
    _build.check(err, "cssm_resample_propagate")
    resample_propagate.launches += 1
    return y, logw


resample_propagate.launches = 0
