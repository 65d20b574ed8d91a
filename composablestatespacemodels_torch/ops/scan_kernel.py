"""K1: systematic resampling counts in one kernel call; K6 batched: the
same counts for B chains in one call; K7a / K7b: the prefix sum and the
int32 running max.

Replaces ``composablestatespacemodels_tpu/ops/scan_kernel.py``'s
``systematic_counts_cols`` (:550) -- and by value its flat form
``systematic_counts_fused`` (:493) -- with the CUDA kernel in
``csrc/counts.cu``: ``counts = cummax(clip(ceil(n*cumsum(w/total) - u), 0,
n))`` with ``counts[-1] = n``, as flat int32 ``[N]``.

On the H100 the kernel is memory-bound: one 4 MiB read of the weights and
one 4 MiB write of the counts at N = 2^20.  The TPU kernel walks its grid
in order with the prefix and running-max carries in SMEM; the CUDA kernel
is one launch of ``csrc/scan.cuh``'s one-launch scan instead: each tile
publishes its float64 sum and, once its counts are formed, its maximum
under epoch-tagged flags, and adds (maxes) those of the tiles before it.
``total`` and ``u`` stay on the device, so a filter step never waits for
the host.

K6 batched (:func:`systematic_counts_batched`, replacing the batched form
``_counts_packed_call`` :302 that ``pmmh_chains`` reaches under ``vmap``)
is K1 on every row (``csrc/counts.cu``): row b of its ``[B, N]`` counts
equals K1 on row b bit for bit.  Rows of at most one tile (N <= 4096, all
of PMMH's) take one launch with no workspace, on blocks sized to the row
(``ceil(N / 128)`` warps, or a warp per row for N <= 128); longer rows take
the three passes.

K7a (:func:`prefix_sum`, replacing ``prefix_sum`` :613) and K7b
(:func:`cummax_int32`, replacing ``cummax_int32`` :480) are the same tile
scan without the counts (``csrc/scan.cu``): every prefix of the port adds
in one order (``scan_kernel.py:617-620`` of the JAX package), and
``inference/resampling.py::_cumsum_ref`` replays it.  K7a, K1 and K7b run
in one launch each, with their tile sums, maxima and flags in one
workspace kept per device and stream, so a call allocates only its
output.

Each wrapper launches its kernel for CUDA tensors and raises for any device
it cannot serve; for CPU tensors (the tests) it computes its ``*_ref``
plain PyTorch version.  Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import itertools

import torch

from ..inference import resampling as rs
from . import _build

_TILE = rs._TILE  # elements per CUDA block (csrc/scan.cuh: kTile)


def systematic_counts_fused_ref(w: torch.Tensor, total: torch.Tensor,
                                u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1, the same function as the kernel."""
    return rs._counts_from_cdf(rs._cumsum_ref(w / total), u, w.shape[0])


def _check_scalar(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name} must be one float32 element on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_flat(x: torch.Tensor, dtype, name: str, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    if x.dtype != dtype or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} [N] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError(f"{name} is empty")


def systematic_counts_fused(w: torch.Tensor, total: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
    """Monotone systematic counts ``int32 [N]`` from weights ``w [N]``,
    ``total = w.sum()`` and the uniform draw ``u`` (device scalars)."""
    if not w.is_cuda:
        if w.device.type == "cpu":
            return systematic_counts_fused_ref(w, total, u)
        _check_flat(w, torch.float32, "w", "K1")         # raises
    # the checks of _check_flat and _check_scalar without their costlier
    # device tests
    if not (w.dtype is torch.float32 and w.dim() == 1 and w.is_contiguous()
            and w.numel()):
        _check_flat(w, torch.float32, "w", "K1")         # raises
    index = w.get_device()
    for t, name in ((total, "total"), (u, "u")):
        if not (t.is_cuda and t.get_device() == index
                and t.dtype is torch.float32 and t.numel() == 1):
            _check_scalar(t, name, w.device)             # raises
    n = w.numel()
    if n >= 2 ** 24:
        raise ValueError(f"N={n} outside (0, 2^24): counts are computed in "
                         "float32, exact below 2^24")
    stream = _build.cuda_stream(index)
    ws = _scan_workspace(w, index, stream, -(-n // _TILE))
    counts = torch.empty(n, dtype=torch.int32, device=w.device)
    err = _build.lib().cssm_systematic_counts(
        w.data_ptr(), total.data_ptr(), u.data_ptr(), counts.data_ptr(),
        ws.data_ptr(), (ws.numel() - 2) // 4, n, next(_SCAN_EPOCHS), index,
        stream)
    _build.check(err, "cssm_systematic_counts")
    systematic_counts_fused.launches += 1
    return counts


systematic_counts_fused.launches = 0


def systematic_counts_batched_ref(w: torch.Tensor, total: torch.Tensor,
                                  u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 batched: K1's plain version on every
    row."""
    return rs._counts_from_cdf(rs._cumsum_ref(w / total[:, None]),
                               u[:, None], w.shape[-1])


def systematic_counts_batched(w: torch.Tensor, total: torch.Tensor,
                              u: torch.Tensor) -> torch.Tensor:
    """Monotone systematic counts ``int32 [B, N]`` for B chains: row b from
    ``w[b]``, ``total[b] = w[b].sum()`` and the uniform ``u[b]``.  One
    kernel launch for rows of N <= 4096, three for longer rows."""
    if not w.is_cuda:
        if w.device.type == "cpu":
            return systematic_counts_batched_ref(w, total, u)
        raise ValueError(f"no K6 batched kernel for device {w.device}")
    if not (w.dtype is torch.float32 and w.dim() == 2 and w.is_contiguous()):
        raise ValueError("w must be a contiguous float32 [B, N] tensor, got "
                         f"{w.dtype} {tuple(w.shape)}")
    b, n = w.shape
    if not 0 < n < 2 ** 24 or not 0 < b < 2 ** 16:
        raise ValueError(f"[B, N] = [{b}, {n}] outside B in (0, 2^16) (the "
                         "grid's second axis), N in (0, 2^24) (counts exact "
                         "in float32)")
    index = w.get_device()
    for t, name in ((total, "total"), (u, "u")):
        if not (t.is_cuda and t.get_device() == index
                and t.dtype is torch.float32 and t.dim() == 1
                and t.shape[0] == b and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{b}] "
                             f"tensor on {w.device}")
    counts = torch.empty((b, n), dtype=torch.int32, device=w.device)
    bsum = bmax = None
    if n > _TILE:       # the three passes' tile sums and maxima
        tiles = -(-n // _TILE)
        bsum = torch.empty((b, tiles), dtype=torch.float64, device=w.device)
        bmax = torch.empty((b, tiles), dtype=torch.int32, device=w.device)
    err = _build.lib().cssm_systematic_counts_batched(
        w.data_ptr(), total.data_ptr(), u.data_ptr(), counts.data_ptr(),
        bsum.data_ptr() if bsum is not None else None,
        bmax.data_ptr() if bmax is not None else None, b, n, index,
        _build.cuda_stream(index))
    _build.check(err, "cssm_systematic_counts_batched")
    systematic_counts_batched.launches += 1
    return counts


systematic_counts_batched.launches = 0


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7a, in the kernel's summation order."""
    return rs._cumsum_ref(x)


# The one-launch scan's workspace per (device index, stream), shared by K7a,
# K1 and K7b: [ticket, done, then a flag and a tile sum per tile, then a
# flag and a tile maximum per tile] as int64 words, for a capacity of
# (numel - 2) / 4 tiles, zeroed once (csrc/scan.cuh, the one-launch scan).
# Calls on one stream run in order, and each kernel's last block resets the
# counters, so a workspace needs no clearing between calls; two streams
# never share one.  Each call tags its flags with a fresh epoch.
_SCAN_WORKSPACES: dict = {}
_SCAN_EPOCHS = itertools.count(1)
_SCAN_MIN_TILES = 1024


def _scan_workspace(x: torch.Tensor, index: int, stream: int,
                    tiles: int) -> torch.Tensor:
    key = (index, stream)
    ws = _SCAN_WORKSPACES.get(key)
    if ws is None or ws.numel() < 2 + 4 * tiles:
        ws = torch.zeros(2 + 4 * max(tiles, _SCAN_MIN_TILES),
                         dtype=torch.int64, device=x.device)
        _SCAN_WORKSPACES[key] = ws
    return ws


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of float32 ``x [N]``: float64 accumulation,
    each entry rounded to float32."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return prefix_sum_ref(x)
        _check_flat(x, torch.float32, "x", "K7a")        # raises
    # the checks of _check_flat without its costlier device test
    if not (x.dtype is torch.float32 and x.dim() == 1 and x.is_contiguous()
            and x.numel()):
        _check_flat(x, torch.float32, "x", "K7a")        # raises
    n = x.numel()
    index = x.get_device()
    stream = _build.cuda_stream(index)
    ws = _scan_workspace(x, index, stream, -(-n // _TILE))
    out = torch.empty_like(x)
    err = _build.lib().cssm_prefix_sum(
        x.data_ptr(), out.data_ptr(), ws.data_ptr(), n, next(_SCAN_EPOCHS),
        index, stream)
    _build.check(err, "cssm_prefix_sum")
    prefix_sum.launches += 1
    return out


prefix_sum.launches = 0


def cummax_int32_ref(c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7b."""
    return torch.cummax(c, dim=0).values


def cummax_int32(c: torch.Tensor) -> torch.Tensor:
    """Exact inclusive running max of int32 ``c [N]``, in one launch."""
    if not c.is_cuda:
        if c.device.type == "cpu":
            return cummax_int32_ref(c)
        _check_flat(c, torch.int32, "c", "K7b")          # raises
    # the checks of _check_flat without its costlier device test
    if not (c.dtype is torch.int32 and c.dim() == 1 and c.is_contiguous()
            and c.numel()):
        _check_flat(c, torch.int32, "c", "K7b")          # raises
    n = c.numel()
    index = c.get_device()
    stream = _build.cuda_stream(index)
    ws = _scan_workspace(c, index, stream, -(-n // _TILE))
    out = torch.empty_like(c)
    err = _build.lib().cssm_cummax_int32(
        c.data_ptr(), out.data_ptr(), ws.data_ptr(), (ws.numel() - 2) // 4, n,
        next(_SCAN_EPOCHS), index, stream)
    _build.check(err, "cssm_cummax_int32")
    cummax_int32.launches += 1
    return out


cummax_int32.launches = 0
