"""Distributed banded direct solve (SPIKE / domain-decomposition LU), and the
row-interleaved real encoding of complex banded matrices (host numpy).

For a banded ``A`` (half-bandwidth ``b``) row-partitioned into ``ndev``
blocks ``A_d`` of size ``blk`` with couplings ``B_d`` (to the next block,
nonzero only in its last ``b`` rows) and ``C_d`` (to the previous block,
first ``b`` rows):

factor (once), on every rank of the ``rows`` axis:
  * the dense LU of its ``A_d`` (``torch.linalg.lu_factor``: cuSOLVER on the
    card) and the spikes ``V_d = A_d^{-1} B_d``, ``W_d = A_d^{-1} C_d``
    (blk x b each);
  * one ``all_gather`` of the spikes' top and bottom ``b`` rows, from which
    every rank assembles the same ``2 b ndev`` reduced matrix and factors it
    (replicated, small).

solve (per RHS): the local ``g_d = A_d^{-1} f_d``; one ``all_gather`` of the
2b boundary rows of ``g`` -> the reduced solve; the local rank-b correction
``x_d = g_d - W_d xb_{d-1} - V_d xt_{d+1}``.

The JAX package assembles the reduced matrix from spikes gathered to the
host (``neptpu/parallel/spike.py:151-173``); here every rank assembles it
from the gathered blocks on its own device, the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import to_numpy_dtype

__all__ = [
    "SpikeBandedSolver",
    "spike_solve_local",
    "dia_strips_from_dense",
    "interleave_complex_banded",
]


def spike_solve_local(lu_d, piv_d, V_d, W_d, r_lu, r_piv, f_d, *, b: int,
                      ndev: int, mesh, axis: str = "rows"):
    """SPIKE solve on one rank: ``lu_d``/``piv_d``/``V_d``/``W_d`` this
    rank's factors ``(blk, blk)``/``(blk,)``/``(blk, b)`` x2, ``r_lu``/
    ``r_piv`` the replicated reduced LU, ``f_d`` the local RHS
    ``(blk[, k])``.  Returns the local solution block ``(blk[, k])``."""
    vec = f_d.ndim == 1
    f2 = f_d[:, None] if vec else f_d
    g = torch.linalg.lu_solve(lu_d, piv_d, f2)
    d = mesh.rank(axis)
    # one all_gather of the top and bottom b rows: (ndev, 2b, k)
    rhs = mesh.all_gather(torch.cat([g[:b], g[-b:]]), axis)
    u = torch.linalg.lu_solve(r_lu, r_piv, rhs.reshape(2 * b * ndev, -1))
    u = u.reshape(ndev, 2 * b, -1)
    x = g
    if d > 0:
        x = x - W_d @ u[d - 1, b:]
    if d < ndev - 1:
        x = x - V_d @ u[d + 1, :b]
    return x[:, 0] if vec else x


def dia_strips_from_dense(A, offsets):
    """Extract diagonal strips strip[j, r] = A[r, r + offsets[j]] (numpy)."""
    A = np.asarray(A)
    n = A.shape[0]
    strips = np.zeros((len(offsets), n), dtype=A.dtype)
    r = np.arange(n)
    for j, off in enumerate(offsets):
        rows = r[: n - off] if off >= 0 else r[-off:]
        strips[j, rows] = A[rows, rows + off]
    return strips


def interleave_complex_banded(strips, offsets):
    """Complex banded (strips over ``offsets``) -> real banded in the
    row-interleaved ordering x = [re_0, im_0, re_1, im_1, ...].

    Each complex entry ``z`` at (r, c) becomes the 2x2 block
    ``[[Re z, -Im z], [Im z, Re z]]`` at rows (2r, 2r+1) / cols (2c, 2c+1),
    so a complex offset ``d`` maps to real offsets ``2d-1, 2d, 2d+1`` and the
    matrix stays banded."""
    strips = np.asarray(strips)
    n = strips.shape[1]
    roffs = sorted({2 * d + s for d in offsets for s in (-1, 0, 1)})
    out = np.zeros((len(roffs), 2 * n), dtype=strips.real.dtype)
    idx = {o: j for j, o in enumerate(roffs)}
    r = np.arange(n)
    for j, d in enumerate(offsets):
        rows = r[: n - d] if d >= 0 else r[-d:]
        re = strips[j].real[rows]
        im = strips[j].imag[rows]
        out[idx[2 * d], 2 * rows] += re
        out[idx[2 * d], 2 * rows + 1] += re
        out[idx[2 * d + 1], 2 * rows] += -im
        out[idx[2 * d - 1], 2 * rows + 1] += im
    return out, roffs


def _local_blocks(s, offsets, blk, b, first, last):
    """This rank's dense ``D (blk, blk)``, coupling to the next block ``B``
    and to the previous block ``C`` (``(blk, b)`` each) from its strips
    ``s (ndiag, blk)``; the chain ends carry no coupling."""
    dev, dt = s.device, s.dtype
    D = torch.zeros((blk, blk), dtype=dt, device=dev)
    B = torch.zeros((blk, b), dtype=dt, device=dev)
    C = torch.zeros((blk, b), dtype=dt, device=dev)
    for j, off in enumerate(offsets):
        if off >= 0:
            D.diagonal(off).copy_(s[j, : blk - off])
            if off > 0 and not last:
                rows = torch.arange(blk - off, blk, device=dev)
                B[rows, rows + off - blk] = s[j, blk - off:]
        else:
            D.diagonal(off).copy_(s[j, -off:])
            if not first:
                rows = torch.arange(0, -off, device=dev)
                C[rows, rows + off + b] = s[j, : -off]
    return D, B, C


class SpikeBandedSolver:
    """Factor once, solve many — the distributed FactorizeLinSolver role.

    Parameters
    ----------
    strips : (ndiag, n) diagonal strips of the banded matrix
             (``strip[j, r] = A[r, r + offsets[j]]``), the same host array on
             every rank
    offsets : matching static offsets
    mesh, axis : the :class:`~neptpu_torch.parallel.mesh.Mesh` and the name
             of its row axis; this rank keeps its block's factors on
             ``mesh.device``
    """

    def __init__(self, strips, offsets, mesh, axis: str = "rows",
                 dtype=None):
        strips = np.asarray(strips)
        if dtype is not None:
            strips = strips.astype(to_numpy_dtype(dtype))
        n = strips.shape[1]
        ndev = int(mesh.size(axis))
        blk = -(-n // ndev)
        b = max(max((abs(o) for o in offsets), default=1), 1)
        if b > blk:
            raise ValueError(f"half-bandwidth {b} > block size {blk}")
        offsets = tuple(int(o) for o in offsets)
        if 0 not in offsets:
            raise ValueError("SPIKE requires a main diagonal (offset 0)")
        self.n, self.ndev, self.blk, self.b = n, ndev, blk, b
        self.mesh, self.axis, self.offsets = mesh, axis, offsets
        d = mesh.rank(axis)
        self.device = mesh.device

        pad = np.zeros((strips.shape[0], ndev * blk), dtype=strips.dtype)
        pad[:, :n] = strips
        # identity on the padded tail keeps every A_d nonsingular
        pad[offsets.index(0), n:] = 1.0
        s = torch.as_tensor(pad[:, d * blk:(d + 1) * blk].copy(),
                            device=self.device)
        D, B, C = _local_blocks(s, offsets, blk, b, d == 0, d == ndev - 1)
        self.lu, self.piv = torch.linalg.lu_factor(D)
        del D
        VW = torch.linalg.lu_solve(self.lu, self.piv, torch.cat([B, C], 1))
        self.V, self.W = VW[:, :b].contiguous(), VW[:, b:].contiguous()

        # ---- replicated reduced system (2 b ndev) -------------------------
        # the spikes' top and bottom b rows of every rank, one all_gather
        ends = mesh.all_gather(torch.cat([self.V[:b], self.W[:b],
                                          self.V[-b:], self.W[-b:]], 1), axis)
        Vt, Wt, Vb, Wb = ends.split(b, dim=2)
        m = 2 * b * ndev
        R = torch.eye(m, dtype=s.dtype, device=self.device)

        def tsl(k):  # rows/cols of xt_k
            return slice(2 * b * k, 2 * b * k + b)

        def bsl(k):  # rows/cols of xb_k
            return slice(2 * b * k + b, 2 * b * (k + 1))

        for k in range(ndev):
            if k > 0:
                R[tsl(k), bsl(k - 1)] += Wt[k]
                R[bsl(k), bsl(k - 1)] += Wb[k]
            if k < ndev - 1:
                R[tsl(k), tsl(k + 1)] += Vt[k]
                R[bsl(k), tsl(k + 1)] += Vb[k]
        self.r_lu = torch.linalg.lu_factor(R)
        self.reduced_size = m

    @property
    def dtype(self):
        return self.lu.dtype

    def solve_sharded(self, f_d):
        """``f_d``: this rank's ``(blk[, k])`` RHS block; returns its
        solution block."""
        return spike_solve_local(
            self.lu, self.piv, self.V, self.W, self.r_lu[0], self.r_lu[1],
            f_d.to(self.device, self.dtype), b=self.b, ndev=self.ndev,
            mesh=self.mesh, axis=self.axis)

    def solve(self, f):
        """Convenience host-side path: ``(n[, k])`` -> ``(n[, k])`` on every
        rank."""
        from .halo import shard_vector, unshard_vector

        f_d = shard_vector(np.asarray(f), self.mesh, self.blk, self.axis)
        return unshard_vector(self.solve_sharded(f_d), self.n, self.mesh,
                              self.axis)

