"""K1: systematic resampling counts in one kernel call.

Replaces ``composablestatespacemodels_tpu/ops/scan_kernel.py``'s
``systematic_counts_cols`` (:550) -- and by value its flat form
``systematic_counts_fused`` (:493) -- with the CUDA kernel in
``csrc/counts.cu``: ``counts = cummax(clip(ceil(n*cumsum(w/total) - u), 0,
n))`` with ``counts[-1] = n``, as flat int32 ``[N]``.

On the H100 the kernel is memory-bound: one 4 MiB read of the weights and
one 4 MiB write of the counts at N = 2^20.  The TPU kernel walks its grid
in order with the prefix and running-max carries in SMEM; the CUDA kernel
is a three-pass parallel scan instead (see the source).  ``total`` and
``u`` stay on the device, so a filter step never waits for the host.

:func:`systematic_counts_fused` launches the kernel for CUDA tensors and
raises for any device it cannot serve; for CPU tensors (the tests) it
computes :func:`systematic_counts_fused_ref`, the plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..inference import resampling as rs
from . import _build

_TILE = 4096  # elements per CUDA block (csrc/counts.cu: kTile)


def systematic_counts_fused_ref(w: torch.Tensor, total: torch.Tensor,
                                u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1, the same function as the kernel."""
    return rs._counts_from_cdf(rs._cumsum(w / total), u, w.shape[0])


def _check_scalar(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name} must be one float32 element on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def systematic_counts_fused(w: torch.Tensor, total: torch.Tensor,
                            u: torch.Tensor) -> torch.Tensor:
    """Monotone systematic counts ``int32 [N]`` from weights ``w [N]``,
    ``total = w.sum()`` and the uniform draw ``u`` (device scalars)."""
    if w.device.type == "cpu":
        return systematic_counts_fused_ref(w, total, u)
    if w.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {w.device}")
    if w.dtype != torch.float32 or w.ndim != 1 or not w.is_contiguous():
        raise ValueError("w must be a contiguous float32 [N] tensor, got "
                         f"{w.dtype} {tuple(w.shape)}")
    _check_scalar(total, "total", w.device)
    _check_scalar(u, "u", w.device)
    n = w.shape[0]
    if not 0 < n < 2 ** 24:
        raise ValueError(f"N={n} outside (0, 2^24): counts are computed in "
                         "float32, exact below 2^24")
    blocks = -(-n // _TILE)
    counts = torch.empty(n, dtype=torch.int32, device=w.device)
    bsum = torch.empty(blocks, dtype=torch.float64, device=w.device)
    bmax = torch.empty(blocks, dtype=torch.int32, device=w.device)
    err = _build.lib().cssm_systematic_counts(
        w.data_ptr(), total.data_ptr(), u.data_ptr(), counts.data_ptr(),
        bsum.data_ptr(), bmax.data_ptr(), n, w.device.index,
        _build.cuda_stream(w.device))
    _build.check(err, "cssm_systematic_counts")
    systematic_counts_fused.launches += 1
    return counts


systematic_counts_fused.launches = 0
