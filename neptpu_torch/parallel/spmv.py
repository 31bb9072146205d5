"""Row-partitioned sparse term banks and the sharded Gram reduction.

The aligned-pattern stacked-CSR bank (``ops/sparse.py``) is partitioned into
contiguous row blocks, one per rank of the ``rows`` axis; each rank keeps its
block's entries, padded to the largest block's count.  The operand ``W`` is
replicated (tall-skinny, k small): each rank produces its row block of
``sum_i A_i W[:, i]`` with one gather and one ``index_add_`` (the JAX body's
``segment_sum``), and an ``all_gather`` of the blocks gives the full vector.
The Gram product ``V^H w`` of row-sharded blocks is a local product and one
``psum``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import SparseTermBank

__all__ = ["RowShardedBank", "sharded_lincomb_apply", "sharded_gram"]


class RowShardedBank:
    """SparseTermBank partitioned into ``ndev`` contiguous row blocks; after
    :meth:`device_put` this rank keeps

    data:    (m, nnz_pad) — its block's term values
    indices: (nnz_pad,)   — their column indices (global)
    rows:    (nnz_pad,)   — their LOCAL row ids within the block
    (pad entries carry data 0 and point at row 0 / col 0: harmless adds)."""

    def __init__(self, bank: SparseTermBank, ndev: int):
        n, m = bank.n, bank.nterms
        self.n, self.ndev, self.nterms = n, ndev, m
        self.block = (n + ndev - 1) // ndev
        self.n_padded = self.block * ndev
        if bank._host is not None:
            self._data, self._indices, self._indptr = bank._host
        else:
            self._data = bank.data.cpu().numpy()
            self._indices = bank.indices.cpu().numpy()
            self._indptr = bank.indptr.cpu().numpy()
        self._row_ids = np.repeat(np.arange(n), np.diff(self._indptr))
        bounds = [min(d * self.block, n) for d in range(ndev + 1)]
        self._starts = [int(self._indptr[b]) for b in bounds]
        self._bounds = bounds
        self.nnz_pad = max(max(self._starts[d + 1] - self._starts[d]
                               for d in range(ndev)), 1)
        self.data = self.indices = self.rows = None

    def device_put(self, mesh, axis: str = "rows"):
        """Keep this rank's padded block on ``mesh.device``."""
        d = mesh.rank(axis)
        s, e = self._starts[d], self._starts[d + 1]
        ln = e - s
        D = np.zeros((self.nterms, self.nnz_pad), dtype=self._data.dtype)
        I = np.zeros(self.nnz_pad, dtype=np.int64)
        R = np.zeros(self.nnz_pad, dtype=np.int64)
        D[:, :ln] = self._data[:, s:e]
        I[:ln] = self._indices[s:e]
        R[:ln] = self._row_ids[s:e] - self._bounds[d]
        dev = mesh.device
        self.data = torch.from_numpy(D).to(dev)
        self.indices = torch.from_numpy(I).to(dev)
        self.rows = torch.from_numpy(R).to(dev)
        return self


def _local_lincomb(data, indices, rows, W, block):
    """One rank's row block of ``sum_i A_i W[:, i]``: ``data (m, nnz)``,
    ``indices``/``rows (nnz,)``, ``W (n, m)`` replicated."""
    dt = torch.promote_types(W.dtype, data.dtype)
    G = W.to(dt)[indices, :]  # (nnz, m) gather from the replicated W
    prod = torch.sum(G * data.to(dt).T, dim=1)
    y = torch.zeros(block, dtype=dt, device=W.device)
    return y.index_add_(0, rows, prod)


def sharded_lincomb_apply(sbank: RowShardedBank, W, mesh,
                          axis: str = "rows"):
    """``y = sum_i A_i W[:, i]``, row-sharded over ``axis``; ``W (n, m)``
    the same on every rank.  Returns the full (gathered) vector of length
    n on every rank."""
    W = torch.as_tensor(W, device=mesh.device)
    y_d = _local_lincomb(sbank.data, sbank.indices, sbank.rows, W,
                         sbank.block)
    return mesh.all_gather(y_d, axis).reshape(-1)[: sbank.n]


def sharded_gram(V_d, w_d, mesh, axis: str = "rows"):
    """``h = V^H w`` with ``V``, ``w`` row-sharded (this rank's blocks
    ``V_d (blk, k)``, ``w_d (blk,)``): the local product and one ``psum``
    (the orthogonalization reduction)."""
    return mesh.psum(V_d.conj().T @ w_d, axis)
