"""Particle and chain sharding on ``torch.distributed``: the PyTorch port
of ``composablestatespacemodels_tpu/parallel/``.

A (chains, particles) ``DeviceMesh`` (:mod:`.mesh`, :mod:`.multihost`)
shards each filter's particle cloud over the particle axis
(:mod:`.sharded_filter`: scalar collectives and a ring of point-to-point
hops for the distributed systematic resampler) and runs independent PMMH
chains over the chain axis (:mod:`.sharded_pmmh`).  NCCL serves CUDA
tensors and gloo CPU tensors; ``python -m
composablestatespacemodels_torch.parallel.dryrun N`` drives every mesh
route in an N-rank gloo world on the CPU.
"""

from .mesh import CHAIN_AXIS, PARTICLE_AXIS, make_mesh, particle_mesh
from .multihost import (hybrid_mesh, initialize_distributed,
                        process_local_chains, replicate_to_mesh,
                        shard_particles_to_mesh)
from .sharded_filter import (distributed_systematic_resample,
                             distributed_systematic_resample_t,
                             sharded_bootstrap_filter,
                             sharded_log_likelihood)
from .sharded_pmmh import (sharded_adaptive_pmmh, sharded_initial_state,
                           sharded_pmmh, sharded_pmmh_monitored)

__all__ = [
    "make_mesh", "particle_mesh", "hybrid_mesh", "CHAIN_AXIS",
    "PARTICLE_AXIS", "initialize_distributed", "replicate_to_mesh",
    "shard_particles_to_mesh", "process_local_chains",
    "distributed_systematic_resample", "distributed_systematic_resample_t",
    "sharded_bootstrap_filter", "sharded_log_likelihood", "sharded_pmmh",
    "sharded_adaptive_pmmh", "sharded_initial_state",
    "sharded_pmmh_monitored",
]
