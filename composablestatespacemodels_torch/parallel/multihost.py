"""Process-group runtime and placement helpers.

PyTorch port of ``composablestatespacemodels_tpu/parallel/multihost.py``.
The layout rule follows the mesh axes' communication:

* the **particle axis** carries per-step collectives (the weight scalars
  and the resampling ring, :mod:`.sharded_filter`), so it stays *within* a
  node, on its NVLink;
* the **chain axis** synchronises nothing inside a filter (independent
  PMMH chains), so it is the axis that may span nodes.

:func:`hybrid_mesh` encodes that: chain rows across nodes, particles over
each node's local ranks.  A node is torchrun's ``LOCAL_WORLD_SIZE`` ranks
of consecutive global rank, as torchrun numbers them.
"""

from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.tree import tree_map
from .mesh import PARTICLE_AXIS, make_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend_for(device) -> str:
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r}; "
                         "'cuda' (NCCL) or 'cpu' (gloo)")
    return _BACKENDS[kind]


def initialize_distributed(device="cuda", *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: Optional[float] = None) -> bool:
    """Initialise the default process group: NCCL for ``device="cuda"``,
    gloo for ``"cpu"`` (only where the caller asks for the CPU).

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set) the group is torchrun's, and on CUDA each rank
    takes card ``LOCAL_RANK``.  ``init_method`` with ``world_size`` and
    ``rank`` names another rendezvous (``tcp://host:port``,
    ``file:///path``).  With neither, the group is a world of one, met
    through a file store in a temporary directory (no network).
    ``timeout`` (seconds) bounds every collective of the group.

    An existing group is kept; it must serve ``device``.  Returns True when
    the world holds more than one rank.
    """
    backend = _backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()}; "
                f"{torch.device(device).type} tensors need {backend}")
        return dist.get_world_size() > 1
    env = os.environ
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed('cuda') needs a CUDA "
                               "device; pass device='cpu' for gloo")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if init_method is None and all(
            k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT")):
        init_method = "env://"
    if init_method is None:
        root = tempfile.mkdtemp(prefix="cssm-dist-")
        atexit.register(shutil.rmtree, root, True)
        store = dist.FileStore(os.path.join(root, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kwargs)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank, **kwargs)
    return dist.get_world_size() > 1


def _nodes():
    """(nodes, ranks per node) of the world, from torchrun's
    ``LOCAL_WORLD_SIZE`` (one node when it is unset)."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not fill nodes of {local}")
    return world // local, local


def hybrid_mesh(n_chains: Optional[int] = None,
                device_type: Optional[str] = None):
    """(chains, particles) mesh that keeps each chain row's particle axis
    within one node.

    ``n_chains`` (default: the number of nodes) must be a multiple of the
    number of nodes, and each node's chain rows must divide its ranks.  A
    world on one node is :func:`~.mesh.make_mesh`'s.
    """
    if not dist.is_initialized():
        initialize_distributed(device_type or "cuda")
    n_nodes, local = _nodes()
    if n_chains is None:
        n_chains = n_nodes
    if n_chains % n_nodes:
        raise ValueError(
            f"n_chains={n_chains} not a multiple of node count {n_nodes}")
    per_node = n_chains // n_nodes
    if per_node > local or local % per_node:
        raise ValueError(f"{per_node} chain rows per node do not divide its "
                         f"{local} local ranks")
    # row-major ranks: row c holds ranks [c * w, (c + 1) * w), w dividing
    # the node's ranks, so no row crosses a node
    return make_mesh(n_chains, dist.get_world_size() // n_chains,
                     device_type)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate_to_mesh(x, mesh):
    """A host-local tree (observations, parameters: every rank loads the
    same) as tensors on this rank's device.  Every rank of a mesh holds
    its own full copy, so no DTensor is needed."""
    device = mesh_device(mesh)

    def one(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device)

    return tree_map(one, x)


def shard_particles_to_mesh(x, mesh, axis: str = PARTICLE_AXIS):
    """A host-local ``[N, ...]`` array, the same on every rank, as this
    rank's slice along ``mesh[axis]``: a ``DTensor`` sharded on dim 0 of
    the global array (what ``initial_state`` of the sharded filter
    takes)."""
    from torch.distributed.tensor import DTensor, Shard

    a = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    sub = mesh[axis]
    n_shards, idx = sub.size(), sub.get_local_rank()
    if a.shape[0] % n_shards:
        raise ValueError(f"{a.shape[0]} rows not divisible by {n_shards} "
                         "shards")
    m = a.shape[0] // n_shards
    local = a[idx * m:(idx + 1) * m].to(mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, sub, [Shard(0)], run_check=False)


def process_local_chains(n_chains: int) -> range:
    """Indices of the PMMH chains this rank's node owns under the
    :func:`hybrid_mesh` layout (for per-node posterior IO)."""
    n_nodes, local = _nodes()
    if n_chains % n_nodes:
        raise ValueError(
            f"n_chains={n_chains} not a multiple of node count {n_nodes}")
    per = n_chains // n_nodes
    node = dist.get_rank() // local
    return range(node * per, (node + 1) * per)
