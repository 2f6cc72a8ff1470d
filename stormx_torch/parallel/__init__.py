"""The distributed layer on ``torch.distributed`` (counterpart of
``stormx/parallel``).

Partitioned CSR, DIA, SlicedELL and BSR operators and whole Krylov solves
split over ranks: each rank runs the solver loop on its slab, the dots are
all-reduces and the halos move by all-gather (CSR, pooled BSR) or neighbour
shifts (DIA, SlicedELL, banded BSR).  The distributed FV march
(``fvm``) and Navier–Stokes step (``ns.ShardedNsProjection``) run the
serial FVM modules on each rank's halo-extended tables, their gathers on
kernel K3; ``commvol`` reports the bytes each layout moves.
``make_device_mesh`` gives a rank its handle, which the solvers take as
``axis_name``.  NCCL carries one rank per card; ranks that share a
card run over gloo as processes, and the CPU ranks of the tests as threads
(``stormx_torch.parallel.comm``: ``RankPool``, ``run_thread_ranks``).
"""

from stormx_torch.parallel.amg import DistributedAmg
from stormx_torch.parallel.block_amg import DistributedBlockDiaAmg
from stormx_torch.parallel.banded import PartitionedDIA, partition_dia, sharded_dia_solve
from stormx_torch.parallel.partition import (
    PartitionedOperator,
    bfs_partition,
    partition_csr,
    partition_vector,
    rcm_order,
    unpartition_vector,
)
from stormx_torch.parallel.bsr import (
    PartitionedBandedBSR,
    partition_bsr_banded,
    PartitionedBSR,
    partition_bsr,
    partition_bsr_vector,
    sharded_bsr_solve,
    unpartition_bsr_vector,
)
from stormx_torch.parallel.fvm import PartitionedFv, partition_fv, sharded_fv_march
from stormx_torch.parallel.ras import build_ras_factors
from stormx_torch.parallel.sharded import make_device_mesh, sharded_matvec, sharded_solve
from stormx_torch.parallel.sliced import (
    PartitionedSliced,
    partition_sliced,
    sharded_sliced_solve,
)

__all__ = [
    "DistributedAmg",
    "DistributedBlockDiaAmg",
    "PartitionedBSR",
    "partition_bsr",
    "partition_bsr_banded",
    "PartitionedBandedBSR",
    "partition_bsr_vector",
    "unpartition_bsr_vector",
    "sharded_bsr_solve",
    "build_ras_factors",
    "PartitionedSliced",
    "partition_sliced",
    "sharded_sliced_solve",
    "PartitionedFv",
    "partition_fv",
    "sharded_fv_march",
    "PartitionedOperator",
    "PartitionedDIA",
    "partition_dia",
    "sharded_dia_solve",
    "bfs_partition",
    "partition_csr",
    "partition_vector",
    "rcm_order",
    "unpartition_vector",
    "make_device_mesh",
    "sharded_matvec",
    "sharded_solve",
]
