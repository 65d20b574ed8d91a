"""The (chains, particles) device mesh on ``torch.distributed``.

PyTorch port of ``composablestatespacemodels_tpu/parallel/mesh.py``.  A
rank is one device (one card, or one CPU process under gloo); the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks with named
dimensions, where

* the **particle axis** shards the N-wide particle cloud: its collectives
  are the per-step weight scalars and the resampling ring
  (:mod:`.sharded_filter`);
* the **chain axis** runs independent PMMH chains, one per mesh row
  (:mod:`.sharded_pmmh`), and synchronises nothing inside a filter.

Ranks are laid out row-major: mesh ``[c, p]`` is global rank
``c * n_particle_shards + p``.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

CHAIN_AXIS = "chains"
PARTICLE_AXIS = "particles"


def _device_type() -> str:
    """The device type of the default process group's backend: NCCL serves
    CUDA tensors, gloo the CPU's."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_chains: int = 1, n_particle_shards: Optional[int] = None,
              device_type: Optional[str] = None):
    """A (chains, particles) mesh over every rank of the process group.

    ``n_chains * n_particle_shards`` must equal the world size; by default
    every rank goes to the particle axis of each chain row.  Without a
    process group, one is made first (:func:`.multihost.initialize_distributed`
    on ``device_type``, default ``"cuda"``: a world of one outside torchrun).
    ``device_type`` defaults to the backend's: ``"cuda"`` over NCCL,
    ``"cpu"`` over gloo.
    """
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import initialize_distributed

    if not dist.is_initialized():
        initialize_distributed(device_type or "cuda")
    n = dist.get_world_size()
    if n_particle_shards is None:
        n_particle_shards = n // n_chains
    if n_chains * n_particle_shards != n:
        raise ValueError(f"mesh {n_chains}x{n_particle_shards} != {n} ranks")
    return init_device_mesh(device_type or _device_type(),
                            (n_chains, n_particle_shards),
                            mesh_dim_names=(CHAIN_AXIS, PARTICLE_AXIS))


def particle_mesh(device_type: Optional[str] = None):
    """1-chain mesh: every rank shards the particle axis."""
    return make_mesh(1, None, device_type)
