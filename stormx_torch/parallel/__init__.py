"""The distributed layer on ``torch.distributed`` (counterpart of
``stormx/parallel``).

Partitioned CSR, DIA and SlicedELL operators and whole Krylov solves split
over ranks: each rank runs the solver loop on its slab, the dots are
all-reduces and the halos move by all-gather (CSR) or neighbour shifts (DIA,
SlicedELL).  ``make_device_mesh`` gives a rank its handle, which the solvers
take as ``axis_name``.  NCCL carries one rank per card; ranks that share a
card run over gloo as processes, and the CPU ranks of the tests as threads
(``stormx_torch.parallel.comm``: ``RankPool``, ``run_thread_ranks``).
"""

from stormx_torch.parallel.amg import DistributedAmg
from stormx_torch.parallel.banded import PartitionedDIA, partition_dia, sharded_dia_solve
from stormx_torch.parallel.partition import (
    PartitionedOperator,
    bandwidth_order,
    bfs_partition,
    partition_csr,
    partition_vector,
    rcm_order,
    unpartition_vector,
)
from stormx_torch.parallel.ras import build_ras_factors
from stormx_torch.parallel.sharded import make_device_mesh, sharded_matvec, sharded_solve
from stormx_torch.parallel.sliced import (
    PartitionedSliced,
    partition_sliced,
    sharded_sliced_solve,
)

__all__ = [
    "DistributedAmg",
    "build_ras_factors",
    "PartitionedSliced",
    "partition_sliced",
    "sharded_sliced_solve",
    "PartitionedOperator",
    "PartitionedDIA",
    "partition_dia",
    "sharded_dia_solve",
    "bfs_partition",
    "partition_csr",
    "partition_vector",
    "rcm_order",
    "bandwidth_order",
    "unpartition_vector",
    "make_device_mesh",
    "sharded_matvec",
    "sharded_solve",
]
