"""K8: B chains' whole T-step bootstrap particle filter in one kernel call,
the likelihood of PMMH's fused tiers.

Replaces ``composablestatespacemodels_tpu/ops/sweep_kernel.py``'s
``pf_sweep_chains`` (:358) with the CUDA kernel in ``csrc/sweep.cu``: one
thread block per chain, ``ceil(n / 32)`` warps with a particle a thread,
holds the cloud in shared memory and runs every step -- propagate with
in-kernel Philox normals, the K3 weights of any of the seven pointwise
observation families with the step's constants for the chain (a masked
step gets weight 0, a select and not a multiply), the max, the float64 sum
and the ll increment ``max + log(total) - log(n)``, the systematic counts
with their running max (the arithmetic of K1, on the ``ceil(n / 128)``
warps that a tile of n items fills: ``csrc/scan.cuh``'s short tiles), the
ancestors and the gather.  ``coef[0]`` is the dt = 0 step, so ``x0`` is
the cloud at the first observation time, as in the JAX package.

The plain version is :func:`pf_sweep_step_ref` in a loop: one step on
``[B, d, n]`` that takes its normals ``z`` and resampling uniforms ``u``
as arguments, so the CPU tests feed it the draws of the JAX kernel in
interpret mode (zero bits), and :func:`sweep_draws` gives it the kernel's
own: Philox4x32-10 with counter (j, r / 4, step, chain) under key (seed, 0)
for the normals and counter (0, 0, step, chain) under key (seed, 1) for
the uniform.  The step replays the kernel's summation orders (the sum of
``u`` and the prefix of ``u / total`` through ``rs._tile_sums`` and
``rs._cumsum_ref``), so kernel and plain version agree bit for bit on the
card.

The wrapper launches the kernel for CUDA tensors and raises for any device
it cannot serve; for CPU tensors (the tests) it runs the plain version.
It counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..inference import resampling as rs
from ..models.observation import _KERNEL_FNS, kernel_fn
from . import _build
from .resample_kernel import _MASK32, philox4x32_10, philox_normals

MAX_PARTICLES = 1024     # the JAX kernel's limit; one particle a thread
# dynamic shared memory a block can hold on an H100 (227 KB), less 1 KiB
# for the kernel's static reduction scratch
MAX_SHARED_BYTES = 232448 - 1024


def sweep_draws(seed: torch.Tensor, steps: int, b: int, d: int, n: int):
    """The kernel's draws for T steps of B chains, all at once: normals
    ``z [T, B, d, n]`` and resampling uniforms ``u [T, B]`` in (0, 1)."""
    step = torch.arange(steps, dtype=torch.int64, device=seed.device)[:, None]
    chain = torch.arange(b, dtype=torch.int64, device=seed.device)[None, :]
    z = philox_normals(seed, d, n, step, chain)
    step, chain = torch.broadcast_tensors(step, chain)
    zero = torch.zeros_like(step)
    w0, _, _, _ = philox4x32_10(
        (zero, zero, step, chain),
        (seed.reshape(()).to(torch.int64) & _MASK32, 1))
    return z, (w0 >> 8).float() * 2.0 ** -24 + 2.0 ** -25


def pf_sweep_step_ref(x: torch.Tensor, coef_t: torch.Tensor,
                      design_t: torch.Tensor, wconsts_t: torch.Tensor,
                      observed, family_id: int, z: torch.Tensor,
                      u: torch.Tensor, log_n: torch.Tensor):
    """One step of K8 for B chains, in the kernel's operation order.

    ``x [B, d, n]`` the clouds, ``coef_t [B, d, 3]`` (a, b, sqrt(q)),
    ``design_t [d]``, ``wconsts_t [B, K]``, ``observed`` a bool (or 0-d
    bool tensor), ``z [B, d, n]`` the normals, ``u [B]`` the resampling
    uniforms, ``log_n`` float32 ``log(n)``.  Returns the resampled clouds
    and the ll increments ``[B]`` (0 where not observed)."""
    b, d, n = x.shape
    a, bb, s = (coef_t[:, :, k, None] for k in range(3))
    x1 = a * x + bb + s * z
    gamma = design_t[0] * x1[:, 0]
    for r in range(1, d):
        gamma = gamma + design_t[r] * x1[:, r]
    observed = torch.as_tensor(observed, device=x.device)
    lw = torch.where(observed,
                     kernel_fn(family_id)(gamma, wconsts_t.T[..., None]), 0.0)
    maxw = lw.max(dim=-1).values
    w = torch.exp(lw - maxw[:, None])
    total = rs._tile_sums(rs._tile_pad(w))[:, 0].to(torch.float32)
    inc = torch.where(observed, (maxw + torch.log(total)) - log_n, 0.0)
    cdf = rs._cumsum_ref(w / total[:, None])
    anc = rs._ancestors_from_counts(rs._counts_from_cdf(cdf, u[:, None], n),
                                    n)
    return torch.gather(x1, 2, anc[:, None, :].long().expand(b, d, n)), inc


def pf_sweep_chains_ref(x0, coef, design, wconsts, mask, seed,
                        family_id: int):
    """Plain PyTorch version of K8: :func:`pf_sweep_step_ref` over the
    steps with the kernel's draws."""
    b, d, n = x0.shape
    log_n = torch.tensor(math.log(n), dtype=torch.float32, device=x0.device)
    x = x0
    ll = torch.zeros(b, dtype=torch.float32, device=x0.device)
    observed = mask.to(torch.bool)
    z, u = sweep_draws(seed, coef.shape[0], b, d, n)
    for t in range(coef.shape[0]):
        x, inc = pf_sweep_step_ref(x, coef[t], design[t], wconsts[t],
                                   observed[t], family_id, z[t], u[t], log_n)
        ll = ll + inc
    return ll, x


def _check_inputs(x0, coef, design, wconsts, mask, seed, family_id) -> None:
    b, d, n = x0.shape
    steps = coef.shape[0]
    dev = x0.device
    k = wconsts.shape[-1] if wconsts.ndim == 3 else 0
    want = {"x0": (x0, torch.float32, (b, d, n)),
            "coef": (coef, torch.float32, (steps, b, d, 3)),
            "design": (design, torch.float32, (steps, d)),
            "wconsts": (wconsts, torch.float32, (steps, b, k)),
            "mask": (mask, torch.int32, (steps,)),
            "seed": (seed, torch.int32, (1,))}
    for name, (t, dtype, shape) in want.items():
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if family_id not in _KERNEL_FNS:
        raise ValueError(f"no K3 device function for family {family_id}")
    if not 0 < k <= 8 or steps == 0 or b == 0:
        raise ValueError(f"need T >= 1 steps, B >= 1 chains and 1 to 8 "
                         f"constants per step, got T={steps}, B={b}, K={k}")


def pf_sweep_chains(x0: torch.Tensor, coef: torch.Tensor,
                    design: torch.Tensor, wconsts: torch.Tensor,
                    mask: torch.Tensor, seed: torch.Tensor, family_id: int):
    """Run B chains' whole bootstrap-filter sweeps in one launch.

    Args:
      x0: ``[B, d, n]`` float32 initial clouds (n <= 1024) at the first
        observation's time.
      coef: ``[T, B, d, 3]`` per-step, per-chain (a, b, sqrt(q)); coef[i]
        advances the cloud from observation i-1 to observation i, coef[0]
        is the dt = 0 step.
      design: ``[T, d]`` design vectors.
      wconsts: ``[T, B, K <= 8]`` per-step, per-chain weight constants
        (the family's ``make_consts``).
      mask: ``[T]`` observation mask, int32 (0: no weight, no ll).
      seed: ``[1]`` int32 sweep seed.
      family_id: the observation family's K3 id.

    Returns ``(ll [B], x_final [B, d, n])``.  Statistically equivalent to
    per-chain ``bootstrap_filter(store="ll")`` resampling at every step.
    """
    b, d, n = x0.shape
    if n > MAX_PARTICLES:
        raise ValueError(f"pf_sweep_chains supports n <= {MAX_PARTICLES}, "
                         f"got {n}")
    smem = (2 * d + 2) * n * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"K8 keeps two [d, n] clouds, the weights and the counts of a "
            f"chain in shared memory: (2d + 2) n * 4 = {smem} bytes at d={d}, "
            f"n={n}, over the {MAX_SHARED_BYTES} bytes a block can hold")
    if x0.device.type == "cpu":
        return pf_sweep_chains_ref(x0, coef, design, wconsts, mask, seed,
                                   family_id)
    if x0.device.type != "cuda":
        raise ValueError(f"no K8 kernel for device {x0.device}")
    _check_inputs(x0, coef, design, wconsts, mask, seed, family_id)
    ll = torch.empty(b, dtype=torch.float32, device=x0.device)
    x_final = torch.empty_like(x0)
    err = _build.lib().cssm_pf_sweep_chains(
        x0.data_ptr(), coef.data_ptr(), design.data_ptr(), wconsts.data_ptr(),
        mask.data_ptr(), seed.data_ptr(), ll.data_ptr(), x_final.data_ptr(),
        b, d, n, coef.shape[0], wconsts.shape[-1], math.log(n), family_id,
        x0.device.index, _build.cuda_stream(x0.device))
    _build.check(err, "cssm_pf_sweep_chains")
    pf_sweep_chains.launches += 1
    return ll, x_final


pf_sweep_chains.launches = 0


def sweep_occupancy(d: int, n: int, family_id: int,
                    device: torch.device) -> dict:
    """K8's resources on a CUDA ``device`` as the CUDA runtime reports them
    for the loaded kernel of ``family_id``: registers and local-memory bytes
    a thread, and the blocks of a launch at (d, n) that one SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 3)()
    err = _build.lib().cssm_pf_sweep_occupancy(
        d, n, family_id, device.index, ctypes.addressof(out))
    _build.check(err, "cssm_pf_sweep_occupancy")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}
