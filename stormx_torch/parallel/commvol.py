"""Exact communication-volume accounting for the partitioned operators
(counterpart of ``stormx/parallel/commvol.py``; host only).

The bytes each operator application moves between ranks follow from the
partition's metadata alone, so they are published beside the bytes of
operator each rank reads, for every distributed layout.

Conventions (per operator application):

* ``moved`` — values received from other ranks, summed over the ranks, in
  elements.  An all-gather pool moves its PADDED buffer (that is the real
  traffic): each rank receives (P−1)·s_max foreign elements.  A halo shift
  moves a fixed strip each way over each of the P−1 live links.
  ``RankMesh.moved`` counts the same bytes as the collectives run.
* ``owned`` — operator values read locally, summed over the ranks (the
  compute-side traffic the communication must hide under).
* ``ratio`` — moved / owned.

Bytes are elements times the operator's item size.  (The JAX package's
``sliced_band_volume`` counts 4 bytes an item whatever the dtype; here it
is the operator's, the same for float32.)

:func:`project_scaling` models P-rank scaling from a measured one-rank
time and these bytes.  It takes the link's rate and latency from the
caller: the port carries no interconnect figure of its own.
"""

from __future__ import annotations

import numpy as np

from stormx_torch.sparse.formats import host

__all__ = [
    "csr_pool_volume",
    "dia_halo_volume",
    "sliced_band_volume",
    "bsr_pool_volume",
    "bsr_band_volume",
    "project_scaling",
]


def _report(moved: int, owned: int, itemsize: int = 4) -> dict:
    return {
        "moved_elems": int(moved),
        "owned_elems": int(owned),
        "moved_bytes": int(moved) * itemsize,
        "owned_bytes": int(owned) * itemsize,
        "ratio": float(moved) / max(owned, 1),
    }


def _owned(a) -> tuple[int, int]:
    """(nonzero count, item size) of an operator array."""
    a = host(a)
    return int(np.count_nonzero(a)), a.dtype.itemsize


def csr_pool_volume(pop) -> dict:
    """CSR shared-pool path (:class:`~stormx_torch.parallel.PartitionedOperator`):
    one ``all_gather`` of the (s_max,) contribution buffer per apply — each
    rank receives (P−1)·s_max foreign elements.  Owned = the (P, n_pad, K)
    operator values actually read."""
    P, s_max = pop.num_parts, pop.s_max
    owned, itemsize = _owned(pop.data)
    return _report(P * (P - 1) * s_max, owned, itemsize)


def dia_halo_volume(pdia) -> dict:
    """Banded DIA path (:class:`~stormx_torch.parallel.PartitionedDIA`): two
    halo strips of h rows each per apply over the (P−1) live links."""
    P, h = pdia.num_parts, pdia.h
    owned, itemsize = _owned(pdia.data)
    return _report(2 * (P - 1) * h, owned, itemsize)


def sliced_band_volume(psell) -> dict:
    """SlicedELL band path (:class:`~stormx_torch.parallel.PartitionedSliced`):
    halos of h_lo (left) and h_hi (right) rows."""
    P = psell.num_parts
    data = psell.dense_blocks if psell.mode == "dense" else psell.ell_data
    owned, itemsize = _owned(data)
    return _report((P - 1) * (psell.h_lo + psell.h_hi), owned, itemsize)


def bsr_pool_volume(pb) -> dict:
    """BSR shared-pool path (:class:`~stormx_torch.parallel.PartitionedBSR`):
    one ``all_gather`` of (s_max, b) block-row contributions per apply."""
    P, s_max, b = pb.num_parts, pb.s_max, pb.block_size
    owned, itemsize = _owned(pb.blocks)
    return _report(P * (P - 1) * s_max * b, owned, itemsize)


def bsr_band_volume(pb) -> dict:
    """Banded BSR path (:class:`~stormx_torch.parallel.PartitionedBandedBSR`):
    two halo strips of h_lo and h_hi block rows × b per apply — constant per
    link, O(P) in all."""
    P, b = pb.num_parts, pb.block_size
    owned, itemsize = _owned(pb.blocks)
    return _report((P - 1) * (pb.h_lo + pb.h_hi) * b, owned, itemsize)


def project_scaling(
    t1_apply_s: float,
    per_link_bytes: float,
    num_parts: int,
    *,
    link_bw: float,
    latency_s: float,
    overlap: bool = True,
) -> dict:
    """Project P-rank SpMV scaling efficiency from first principles.

    ``t1_apply_s``: a measured one-rank time per apply.
    ``per_link_bytes``: bytes the busiest link carries per apply (halo
    layouts: the one-direction strip; all-gather pools: the (P−1)/P ring
    share each rank relays).  ``link_bw`` (bytes/s, one way, per link) and
    ``latency_s`` (per collective hop) describe the interconnect and have
    no default.

    Model: per-rank compute is T1/P (the product is bandwidth-bound, so
    throughput per rank is size-independent until slabs get tiny); the
    communication term is ``latency + bytes/link_bw``, hidden behind the
    interior rows when ``overlap`` up to the point where it exceeds the
    compute.  Efficiency = T1 / (P · T_P).
    """
    compute = t1_apply_s / num_parts
    comm = latency_s + per_link_bytes / link_bw
    t_p = max(compute, comm) if overlap else compute + comm
    return {
        "P": num_parts,
        "t1_us": t1_apply_s * 1e6,
        "tP_us": t_p * 1e6,
        "compute_us": compute * 1e6,
        "comm_us": comm * 1e6,
        "efficiency": t1_apply_s / (num_parts * t_p),
        "comm_bound": comm > compute,
    }
