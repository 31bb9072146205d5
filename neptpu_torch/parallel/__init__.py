"""Distributed layer: process meshes, the halo-exchange sharded DIA bank,
SPIKE banded solves, the row-sharded CSR bank and node-sharded quadrature,
SPMD over ``torch.distributed``.

* ``mesh``  — the ``(rows, nodes)`` :class:`Mesh` over a ``DeviceMesh`` and
  its collectives (``psum``, ``all_gather``, ``neighbour_exchange`` and its
  started form ``neighbour_exchange_start``);
  ``initialize_distributed`` wires a group from the torchrun variables;
* ``halo``  — row-partitioned DIA term banks with neighbour halo exchange:
  operand and vectors sharded, each rank's apply one kernel-B1 launch on its
  block while the strips travel, then the boundary corrections
  (``ShardedDiaBank``, ``sharded_dia_lincomb``);
* ``spike`` — the distributed banded direct solve (SPIKE);
* ``spmv``  — the row-sharded CSR bank (replicated operand) and the psum
  Gram reduction;
* ``quadrature`` — contour nodes split over the ``nodes`` axis;
* ``mixed_sharded`` — the sharded mixed bank and SPIKE + SMW solve, and the
  sharded IAR scan of the gun/WEP class (``iar_real_spmf_sharded``).

Every rank calls the same function with the same host inputs and holds its
own block (the JAX package's single-controller ``shard_map`` bodies become
SPMD code).  The delay-problem consumer is
``neptpu_torch.solvers.iar_sharded.iar_real_sharded``.  ``P`` and
``NamedSharding`` of the JAX package's ``__all__`` re-export
``jax.sharding`` and have no counterpart here (see ``mesh``).
"""
from .mesh import Mesh, initialize_distributed, make_mesh
from .halo import (
    ShardedDiaBank,
    halo_exchange,
    local_halo_lincomb,
    shard_vector,
    sharded_dia_lincomb,
    unshard_vector,
)
from .spike import (
    SpikeBandedSolver,
    dia_strips_from_dense,
    interleave_complex_banded,
    spike_solve_local,
)
from .spmv import RowShardedBank, sharded_gram, sharded_lincomb_apply
from .quadrature import sharded_contour_moments

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "Mesh",
    "ShardedDiaBank",
    "sharded_dia_lincomb",
    "halo_exchange",
    "local_halo_lincomb",
    "shard_vector",
    "unshard_vector",
    "SpikeBandedSolver",
    "spike_solve_local",
    "dia_strips_from_dense",
    "interleave_complex_banded",
    "RowShardedBank",
    "sharded_lincomb_apply",
    "sharded_gram",
    "sharded_contour_moments",
]
