"""The ring's hops a filter step: card 0's NCCL point-to-point kernel
launches (one ``batch_isend_irecv`` of the visiting block and its counts a
hop) over the traced filter steps.  Blocks travel to the right only, so a
step takes 1 hop where every shard's slots draw their ancestors from it
and its left neighbour, and ``shards - 1`` where some shard's slots draw
from its right neighbour.  Kernels matched: NCCL kernels whose name holds
``SendRecv``, ``Send`` or ``Recv`` (on the H100s, NCCL 2.28.9,
``ncclDevKernel_SendRecv``); None where the trace holds no NCCL kernel at
all."""

COLLECTIVES = r"(?i)nccl"
P2P = r"(?i)nccl.*(SendRecv|Send|Recv)"


def read(run):
    steps = sum(1 for u in run.units if u["traced"]) \
        * run.driver.steps_per_unit(run)
    if run.trace is None or not steps or not run.trace.kernels(COLLECTIVES):
        return None
    return len(run.trace.kernels(P2P)) / steps
