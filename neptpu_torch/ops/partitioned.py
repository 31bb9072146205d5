"""Partitioned banded LU + low-rank SMW — the structure-exploiting shifted
solve for the gun problem class on one card.

The complex shifted matrix of a mixed SPMF is

    M(sigma) = B(sigma) + sum_lr f_i(sigma) L_i U_i^T

with ``B`` banded (the FD/FEM bulk terms) and a low-rank boundary part.

* The banded bulk rides in the ROW-INTERLEAVED real encoding
  (``parallel/spike.py``): complex entry z -> 2x2 block [[Re,-Im],[Im,Re]]
  at interleaved rows/cols, which keeps the matrix banded.
* The banded solve is the SPIKE domain decomposition [Polizzi & Sameh],
  batched over ``p`` partitions on one device: p dense factorizations of
  (blk, blk) diagonal blocks + two (blk, b) spikes each + one (2 b p)^2
  reduced system — O(n blk^2) flops instead of O(n^2 blk).  The
  block-Thomas ``BlockTridiagSolver`` is the alternative for wide bands.
* The low-rank part folds in by Sherman–Morrison–Woodbury: with
  ``X = B^-1 Ltil`` precomputed once, each solve costs one banded solve +
  three tall-skinny GEMMs.
* ``mode='inv'`` stores explicit per-partition inverses, so the per-step
  solve is batched GEMM only (plus residual refinement); ``mode='lu'`` keeps
  pivoted LU solves for float64 reference runs.

Batched factorizations run on ``torch.linalg`` and the products on
``torch.matmul`` (cuSOLVER/cuBLAS on the card) — no hand kernel here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype, to_torch_dtype
from ..core import trace

__all__ = [
    "csr_to_strips",
    "rot_i",
    "complex_lowrank_to_half",
    "complex_lowrank_to_interleaved",
    "interleave_pair",
    "deinterleave_pair",
    "PartitionedBandedSolver",
    "BlockTridiagSolver",
    "InterleavedSMW",
    "assemble_shift_parts",
    "build_spmf_shift_solver",
    "ShiftPlan",
    "BatchedShiftSMW",
    "BATCH_SIZES",
    "canonical_batch",
    "arrow_split",
    "band_border_split",
]


def csr_to_strips(A):
    """scipy sparse -> (strips, offsets): strip[j, r] = A[r, r + offsets[j]]
    over the diagonals that carry nonzeros."""
    coo = A.tocoo()
    n = A.shape[0]
    d = coo.col - coo.row
    offs = np.unique(d)
    strips = np.zeros((len(offs), n), dtype=coo.data.dtype)
    np.add.at(strips, (np.searchsorted(offs, d), coo.row), coo.data)
    return strips, [int(o) for o in offs]


def interleave_pair(zre, zim):
    """(re, im) channel pair (n, ...) -> interleaved (2n, ...)."""
    return torch.stack([zre, zim], dim=1).reshape((-1,) + tuple(zre.shape[1:]))


def deinterleave_pair(x):
    """Interleaved (2n, ...) -> (re, im) pair of (n, ...)."""
    x2 = x.reshape((-1, 2) + tuple(x.shape[1:]))
    return x2[:, 0], x2[:, 1]


def rot_i(x, dim=0):
    """Row-interleaved real form of multiplication by ``i`` along the row
    axis ``dim``.  The interleaved form of any complex-linear operator (the
    banded bulk, its inverse, the SMW correction) commutes with this map,
    which lets every tall-skinny SMW operand carry R columns instead of 2R."""
    dim = dim % x.ndim
    x2 = x.unflatten(dim, (-1, 2))
    return torch.stack([-x2.select(dim + 1, 1), x2.select(dim + 1, 0)],
                       dim=dim + 1).reshape(x.shape)


def _rows_rot_i(x):
    """:func:`rot_i` over the rows of ``(..., rows, k)`` operands."""
    return rot_i(x, dim=-2)


def complex_lowrank_to_half(Lc, Uc):
    """Complex rank-R factors (n, R) x2 with A = Lc Uc^T -> HALF real factors
    (2n, R) x2 in the row-interleaved encoding: the full real factors are
    ``[Lh, rot_i(Lh)]`` and ``[Uh, rot_i(Uh)]``, so only the halves are
    stored (host numpy)."""
    Lc = np.asarray(Lc)
    Uc = np.asarray(Uc)
    n, R = Lc.shape
    Lh = np.zeros((2 * n, R), dtype=Lc.real.dtype)
    Uh = np.zeros((2 * n, R), dtype=Uc.real.dtype)
    Lh[0::2] = Lc.real
    Lh[1::2] = Lc.imag
    Uh[0::2] = Uc.real
    Uh[1::2] = -Uc.imag
    return Lh, Uh



def complex_lowrank_to_interleaved(Lc, Uc):
    """Complex rank-R factors (n, R) x2 with A = Lc Uc^T -> real factors
    (2n, 2R) x2 in the row-interleaved encoding: ``Ltil Util^T`` equals
    ``P [[Re A, -Im A], [Im A, Re A]] P^T`` (P the interleaving permutation).
    The full form of :func:`complex_lowrank_to_half`'s halves, which the
    sharded SMW solve takes (host numpy)."""
    Lc = np.asarray(Lc)
    Uc = np.asarray(Uc)
    n, R = Lc.shape
    Ltil = np.zeros((2 * n, 2 * R), dtype=Lc.real.dtype)
    Util = np.zeros((2 * n, 2 * R), dtype=Uc.real.dtype)
    Ltil[0::2, :R] = Lc.real
    Ltil[0::2, R:] = -Lc.imag
    Ltil[1::2, :R] = Lc.imag
    Ltil[1::2, R:] = Lc.real
    Util[0::2, :R] = Uc.real
    Util[0::2, R:] = Uc.imag
    Util[1::2, :R] = -Uc.imag
    Util[1::2, R:] = Uc.real
    return Ltil, Util

def _block_index_lists(offsets, blk, b):
    """Host index lists of the diagonal block D, the coupling to the next
    block B and from the previous block C, for strips over ``offsets``."""
    d, bb, c = ([], [], []), ([], [], []), ([], [], [])
    for j, off in enumerate(offsets):
        r = np.arange(max(0, -off), blk - max(0, off))
        d[0].append(r)
        d[1].append(r + off)
        d[2].append(np.full(len(r), j))
        if off > 0:  # coupling to the NEXT block
            r2 = np.arange(blk - off, blk)
            bb[0].append(r2)
            bb[1].append(r2 + off - blk)
            bb[2].append(np.full(off, j))
        elif off < 0:  # coupling to the PREVIOUS block
            r2 = np.arange(0, -off)
            c[0].append(r2)
            c[1].append(r2 + off + b)
            c[2].append(np.full(-off, j))

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    return [tuple(cat(p) for p in lists) for lists in (d, bb, c)]


def _assemble_DBC(strips, offsets, nblk, blk, b, bcols):
    """strips (..., ndiag, nblk*blk) -> block form D (..., nblk, blk, blk)
    and the couplings B/C (..., nblk, blk, bcols); leading axes (a batch of
    shifts) pass through.  One scatter per block kind over host index lists
    (the (row, col) pairs are distinct, so assignment into zeros is the sum).
    Strip convention: strip[j, r] = A[r, r + off_j], r the local row."""
    dev = strips.device
    lead = tuple(strips.shape[:-2])
    s = strips.reshape(lead + (len(offsets), nblk, blk)).movedim(-3, -2)
    out = []
    for (rows, cols, jj), shape in zip(_block_index_lists(offsets, blk, b),
                                       ((blk, blk), (blk, bcols),
                                        (blk, bcols))):
        rows = torch.as_tensor(rows, device=dev)
        cols = torch.as_tensor(cols, device=dev)
        jj = torch.as_tensor(jj, device=dev)
        M = torch.zeros(lead + (nblk,) + shape, dtype=strips.dtype,
                        device=dev)
        M[..., rows, cols] = s[..., jj, rows]
        out.append(M)
    D, B, C = out
    B[..., -1, :, :] = 0.0
    C[..., 0, :, :] = 0.0
    return D, B, C


def _factor_partitioned(strips, offsets, p, blk, b, mode):
    """strips (..., ndiag, p*blk) -> per-partition factors, spikes and the
    factored reduced system; all partitions (and all leading shifts)
    factored in one batch."""
    dt, dev = strips.dtype, strips.device
    lead = tuple(strips.shape[:-2])
    D, B, C = _assemble_DBC(strips, offsets, p, blk, b, b)
    BC = torch.cat([B, C], dim=-1)
    if mode == "inv":
        fac = torch.linalg.inv(D)  # batched; the hot-path solve is pure GEMM
        piv = torch.zeros(lead + (p, blk), dtype=torch.int32, device=dev)
        VW = fac @ BC
    else:
        fac, piv = torch.linalg.lu_factor(D)
        VW = torch.linalg.lu_solve(fac, piv, BC)
    V, W = VW[..., :b].contiguous(), VW[..., b:].contiguous()

    # reduced system over the spike boundary rows (2 b p)
    m = 2 * b * p
    R = torch.eye(m, dtype=dt, device=dev).expand(lead + (m, m)).clone()
    for d in range(p):
        t = 2 * b * d
        if d > 0:
            R[..., t:t + b, t - b:t] += W[..., d, :b, :]
            R[..., t + b:t + 2 * b, t - b:t] += W[..., d, -b:, :]
        if d < p - 1:
            R[..., t:t + b, t + 2 * b:t + 3 * b] += V[..., d, :b, :]
            R[..., t + b:t + 2 * b, t + 2 * b:t + 3 * b] += V[..., d, -b:, :]
    if mode == "inv":
        r_fac = torch.linalg.inv(R)
        r_piv = torch.zeros(lead + (m,), dtype=torch.int32, device=dev)
    else:
        r_fac, r_piv = torch.linalg.lu_factor(R)
    return fac, piv, V, W, r_fac, r_piv, (D, B, C)


def _pad_strips(strips, offsets, total):
    """Pad strips to ``total`` rows with an identity tail (keeps the blocks
    regular)."""
    pad = np.zeros((strips.shape[0], total), dtype=strips.dtype)
    pad[:, :strips.shape[1]] = strips
    pad[offsets.index(0), strips.shape[1]:] = 1.0
    return pad


def _as_cols(f):
    return (f[:, None], True) if f.ndim == 1 else (f, False)


class PartitionedBandedSolver:
    """SPIKE-partitioned banded direct solver on one device (batched over
    partitions).  Factor once, solve many.

    ``mode='inv'``: per-partition explicit inverses — the solve is batched
    GEMM only.  ``mode='lu'``: pivoted LU + triangular solves."""

    def __init__(self, strips, offsets, p=16, dtype=None, mode="inv",
                 device=None):
        strips = np.asarray(strips)
        if dtype is not None:
            strips = strips.astype(to_numpy_dtype(dtype))
        n = strips.shape[1]
        offsets = tuple(int(o) for o in offsets)
        b = max(max((abs(o) for o in offsets), default=1), 1)
        p = int(p)
        blk = -(-n // p)
        while blk < b:  # shrink partition count until blocks cover the band
            p = max(p // 2, 1)
            blk = -(-n // p)
        if 0 not in offsets:
            raise ValueError("banded solver requires a main diagonal")
        self.offsets, self.p, self.blk, self.b, self.n = offsets, p, blk, b, n
        self.mode = mode
        self.strips = torch.from_numpy(
            _pad_strips(strips, offsets, p * blk)).to(resolve_device(device))
        (self.fac, self.piv, self.V, self.W, self.r_fac, self.r_piv,
         self.DBC) = _factor_partitioned(self.strips, offsets, p, blk, b, mode)

    @classmethod
    def from_factors(cls, fac, piv, V, W, r_fac, r_piv, strips, DBC, offsets,
                     p, blk, b, n, mode):
        """Rebuild a solver from stored factors (see ``interop``)."""
        obj = cls.__new__(cls)
        (obj.fac, obj.piv, obj.V, obj.W, obj.r_fac, obj.r_piv, obj.strips,
         obj.DBC) = fac, piv, V, W, r_fac, r_piv, strips, tuple(DBC)
        obj.offsets = tuple(int(o) for o in offsets)
        obj.p, obj.blk, obj.b, obj.n, obj.mode = p, blk, b, n, mode
        return obj

    def matvec(self, x):
        """y = B x through the block form: three batched GEMMs (couplings
        reach only the adjacent partitions since b <= blk).  x: (n,), (n, k),
        or (..., n, k) against factors with leading shift axes."""
        p, blk, b, n = self.p, self.blk, self.b, self.n
        D, B, C = self.DBC
        x, one_d = _as_cols(x)
        lead, k = tuple(x.shape[:-2]), x.shape[-1]
        xp = torch.zeros(lead + (p * blk, k), dtype=x.dtype, device=x.device)
        xp[..., :n, :] = x[..., :n, :]
        xb = xp.reshape(lead + (p, blk, k))
        y = D @ xb
        y[..., :-1, :, :] += B[..., :-1, :, :] @ xb[..., 1:, :b, :]
        y[..., 1:, :, :] += C[..., 1:, :, :] @ xb[..., :-1, blk - b:, :]
        y = y.reshape(lead + (p * blk, k))[..., :n, :]
        return y[:, 0] if one_d else y

    def _local(self, f):
        """Batched per-partition solve, f (p, blk, k)."""
        if self.mode == "inv":
            return self.fac @ f
        return torch.linalg.lu_solve(self.fac, self.piv, f)

    def _reduced(self, rhs):
        if self.mode == "inv":
            return self.r_fac @ rhs
        return torch.linalg.lu_solve(self.r_fac, self.r_piv, rhs)

    def solve(self, f):
        """f: (n,) or (n, k) -> solution of the banded system; (..., n, k)
        against factors with leading shift axes (one system per shift)."""
        p, blk, b, n = self.p, self.blk, self.b, self.n
        f, one_d = _as_cols(f)
        lead, k = tuple(f.shape[:-2]), f.shape[-1]
        fp = torch.zeros(lead + (p * blk, k), dtype=f.dtype, device=f.device)
        fp[..., :n, :] = f
        g = self._local(fp.reshape(lead + (p, blk, k)))
        # reduced RHS: top/bottom b rows of every partition, interleaved
        rhs = torch.cat([g[..., :b, :], g[..., -b:, :]], dim=-2)  # (p, 2b, k)
        u = self._reduced(rhs.reshape(lead + (p * 2 * b, k))).reshape(
            lead + (p, 2 * b, k))
        # corrections: x_d = g_d - W_d @ xb_{d-1} - V_d @ xt_{d+1}
        zero = torch.zeros(lead + (1, b, k), dtype=f.dtype, device=f.device)
        xb_prev = torch.cat([zero, u[..., :-1, b:, :]], dim=-3)
        xt_next = torch.cat([u[..., 1:, :b, :], zero], dim=-3)
        x = g - self.W @ xb_prev - self.V @ xt_next
        x = x.reshape(lead + (p * blk, k))[..., :n, :]
        return x[:, 0] if one_d else x


class BlockTridiagSolver:
    """Block-Thomas direct solver for wide-band matrices on one device.

    With block size bt = half-bandwidth the banded matrix is exactly block
    tridiagonal; the Schur recursion S_i = D_i - C_i S_{i-1}^{-1} B_{i-1}
    stores S_i^{-1} (factor cost O(n bt^2)), and a solve is a forward and a
    backward sweep of small GEMMs.  Same interface as
    :class:`PartitionedBandedSolver`."""

    def __init__(self, strips, offsets, dtype=None, mode="inv", refine=None,
                 device=None):
        strips = np.asarray(strips)
        if dtype is not None:
            strips = strips.astype(to_numpy_dtype(dtype))
        n = strips.shape[1]
        offsets = tuple(int(o) for o in offsets)
        if 0 not in offsets:
            raise ValueError("banded solver requires a main diagonal")
        bt = max(max((abs(o) for o in offsets), default=1), 1)
        nblk = -(-n // bt)
        self.offsets, self.nblk, self.bt, self.n = offsets, nblk, bt, n
        self.mode = mode  # the factors are inverses either way
        # the nblk sequential Schur steps accumulate ~kappa_block eps per
        # block — inner banded refinement wins the digits back in float32
        self.refine = int(refine) if refine is not None else (
            2 if strips.dtype == np.float32 else 0)
        self.strips = torch.from_numpy(
            _pad_strips(strips, offsets, nblk * bt)).to(resolve_device(device))
        self.D, self.B, self.C = _assemble_DBC(self.strips, offsets, nblk, bt,
                                               bt, bt)
        Sinv = []
        prev = torch.zeros((bt, bt), dtype=self.D.dtype, device=self.D.device)
        for i in range(nblk):
            S = self.D[i]
            if i > 0:
                S = S - self.C[i] @ (prev @ self.B[i - 1])
            prev = torch.linalg.inv(S)
            Sinv.append(prev)
        self.Sinv = torch.stack(Sinv)

    @classmethod
    def from_factors(cls, Sinv, B, C, D, strips, offsets, nblk, bt, n, mode,
                     refine):
        """Rebuild a solver from stored factors (see ``interop``)."""
        obj = cls.__new__(cls)
        obj.Sinv, obj.B, obj.C, obj.D, obj.strips = Sinv, B, C, D, strips
        obj.offsets = tuple(int(o) for o in offsets)
        obj.nblk, obj.bt, obj.n, obj.mode = nblk, bt, n, mode
        obj.refine = int(refine)
        return obj

    def matvec(self, x):
        nblk, bt, n = self.nblk, self.bt, self.n
        x, one_d = _as_cols(x)
        k = x.shape[1]
        xp = torch.zeros((nblk * bt, k), dtype=x.dtype, device=x.device)
        xp[:n] = x[:n]
        xb = xp.reshape(nblk, bt, k)
        y = self.D @ xb
        y[:-1] += self.B[:-1] @ xb[1:]
        y[1:] += self.C[1:] @ xb[:-1]
        y = y.reshape(nblk * bt, k)[:n]
        return y[:, 0] if one_d else y

    def solve(self, f):
        x = self._solve_raw(f)
        for _ in range(self.refine):
            x = x + self._solve_raw(f - self.matvec(x))
        return x

    def _solve_raw(self, f):
        """Forward/backward block-Thomas sweeps; f (n[, k])."""
        nblk, bt, n = self.nblk, self.bt, self.n
        f, one_d = _as_cols(f)
        k = f.shape[1]
        fp = torch.zeros((nblk * bt, k), dtype=f.dtype, device=f.device)
        fp[:n] = f
        fb = fp.reshape(nblk, bt, k)
        Y = torch.empty_like(fb)
        y = torch.zeros((bt, k), dtype=f.dtype, device=f.device)
        for i in range(nblk):
            y = fb[i] if i == 0 else fb[i] - self.C[i] @ (self.Sinv[i - 1] @ y)
            Y[i] = y
        X = torch.empty_like(fb)
        x = torch.zeros((bt, k), dtype=f.dtype, device=f.device)
        for i in range(nblk - 1, -1, -1):
            x = self.Sinv[i] @ (Y[i] - self.B[i] @ x)
            X[i] = x
        x = X.reshape(nblk * bt, k)[:n]
        return x[:, 0] if one_d else x


def _smw_K(Xh, Uh):
    """The 2R x 2R capacitance K = I + Util^T X from the HALF operands:
    K = [[I+P, Q], [-Q, I+P]], P = Uh^T Xh, Q = Uh^T rot_i(Xh)."""
    R = Xh.shape[-1]
    P = Uh.mT @ Xh
    Q = Uh.mT @ _rows_rot_i(Xh)
    A = torch.eye(R, dtype=Xh.dtype, device=Xh.device) + P
    return torch.cat([torch.cat([A, Q], dim=-1), torch.cat([-Q, A], dim=-1)],
                     dim=-2)


class InterleavedSMW:
    """Shifted-solve operand for the complex-as-real scan: banded bulk via
    :class:`PartitionedBandedSolver` / :class:`BlockTridiagSolver`
    (row-interleaved real encoding) plus a Sherman–Morrison–Woodbury
    low-rank correction:

        M x = f  with  M = B + Ltil Util^T
        x = B^-1 f - X K^-1 (Util^T B^-1 f),   X = B^-1 Ltil,
        K = I + Util^T X   (factored once, 2R x 2R).

    The tall operands are stored as HALVES (``Lh``/``Uh``/``X``, R columns);
    the rot_i row swap supplies the other half.  Exposes
    ``solve_pair(zre, zim) -> (xre, xim)``, the contract of the scan."""

    def __init__(self, base, Lh=None, Uh=None, refine=None):
        self.base = base
        self.mode = base.mode
        # explicit inverses trade ~3 digits of solve accuracy for the
        # pure-GEMM hot path; residual-refinement steps win them back
        self.refine = int(refine) if refine is not None else (
            2 if self.mode == "inv" else 0)
        self.X = self.Uh = self.Lh = self.K_fac = self.K_piv = None
        if Lh is None:
            return
        self.Lh, self.Uh = Lh, Uh
        self.X = base.solve(Lh)
        K = _smw_K(self.X, Uh)
        if self.mode == "inv":
            self.K_fac = torch.linalg.inv(K)
            self.K_piv = torch.zeros(K.shape[:-1], dtype=torch.int32,
                                     device=K.device)
        else:
            self.K_fac, self.K_piv = torch.linalg.lu_factor(K)

    @classmethod
    def from_factors(cls, base, X, Uh, Lh, K_fac, K_piv, mode, refine):
        """Rebuild a solver from stored factors (see ``interop``)."""
        obj = cls.__new__(cls)
        obj.base, obj.X, obj.Uh, obj.Lh = base, X, Uh, Lh
        obj.K_fac, obj.K_piv = K_fac, K_piv
        obj.mode, obj.refine = mode, int(refine)
        return obj

    @property
    def n(self):
        return self.base.n // 2  # complex length

    def _ut_pair(self, x):
        """t = Util^T x over the half form: [Uh^T x; -Uh^T rot_i(x)]."""
        return torch.cat([self.Uh.mT @ x, -(self.Uh.mT @ _rows_rot_i(x))],
                         dim=-2)

    def _x_apply(self, M, u):
        """[M, rot_i(M)] @ u for tall half operand M (2n, R), u (2R[, k])."""
        R = M.shape[-1]
        return M @ u[..., :R, :] + _rows_rot_i(M @ u[..., R:, :])

    def matvec(self, x):
        """y = M x = B x + Ltil (Util^T x)."""
        y = self.base.matvec(x)
        if self.X is not None:
            xc, one_d = _as_cols(x)
            y2 = self._x_apply(self.Lh, self._ut_pair(xc))
            y = y + (y2[:, 0] if one_d else y2)
        return y

    def _solve_once(self, f):
        g = self.base.solve(f)
        if self.X is None:
            return g
        gc, one_d = _as_cols(g)
        t = self._ut_pair(gc)
        if self.mode == "inv":
            u = self.K_fac @ t
        else:
            u = torch.linalg.lu_solve(self.K_fac, self.K_piv, t)
        c = self._x_apply(self.X, u)
        return g - (c[:, 0] if one_d else c)

    def solve(self, f):
        x = self._solve_once(f)
        for _ in range(self.refine):
            x = x + self._solve_once(f - self.matvec(x))
        return x

    def solve_pair(self, zre, zim):
        return deinterleave_pair(self.solve(interleave_pair(zre, zim)))


def _support(A):
    coo = A.tocoo()
    if coo.nnz == 0:
        return 0
    return min(len(np.unique(coo.row)), len(np.unique(coo.col)))


def assemble_shift_parts(mats, fv, sigma, max_rank=None):
    """Host-side banded + low-rank decomposition of ``M(sigma)``.

    Splits terms by the bounding-box criterion (low-rank when the nonzero
    support is small), sums the remaining bulk at ``sigma`` in complex128,
    and arrow-splits the sum (band + exact border factors).  Returns
    ``(strips, offsets, Lc, Uc)`` with ``M(sigma) == band + Lc Uc^T``
    (``Lc``/``Uc`` possibly ``None``), or ``None`` when the bulk is neither
    banded nor an arrow."""
    import scipy.sparse as sp

    from ..models.lowrank import low_rank_factors
    from ..solvers.spmf_real import spmf_fun_scalars

    seq = [sp.csr_matrix(A) if not sp.issparse(A) else A.tocsr()
           for A in mats]
    n = seq[0].shape[0]
    if max_rank is None:
        max_rank = max(32, n // 64)
    w = spmf_fun_scalars(fv, sigma)
    Bulk = None
    Ls, Us = [], []
    for wi, A in zip(w, seq):
        if A.nnz and _support(A) <= max_rank:
            L, U = low_rank_factors(A)  # A = L @ U^H
            Ls.append(wi * np.asarray(L).astype(complex))
            Us.append(np.conj(np.asarray(U)).astype(complex))  # A = L Uc^T
        else:
            T = A.astype(complex) * wi
            Bulk = T if Bulk is None else Bulk + T
    if Bulk is None:
        return None
    split = band_border_split(Bulk.tocsr(), max_rank=max_rank)
    if split is None:
        return None
    strips, offs, bLs, bUs = split
    Ls.extend(bLs)
    Us.extend(bUs)
    Lc = np.hstack(Ls) if Ls else None
    Uc = np.hstack(Us) if Us else None
    return strips, offs, Lc, Uc


def build_spmf_shift_solver(mats, fv, sigma, dtype=torch.float32, p=16,
                            mode=None, max_rank=None, device=None):
    """Assemble the InterleavedSMW solver for M(sigma) of a mixed SPMF (see
    :func:`assemble_shift_parts`); interleaves on the host and factors on
    ``device``.  Returns ``None`` when the bulk is not usefully banded
    (callers fall back to the dense block LU).  ``device=None`` is the card
    (``config.default_device``)."""
    from ..parallel.spike import interleave_complex_banded

    device = resolve_device(device)
    with trace.span("nt.factorize.assemble"):
        parts = assemble_shift_parts(mats, fv, sigma, max_rank=max_rank)
        if parts is None:
            return None
        strips, offs, Lc, Uc = parts
        rstrips, roffs = interleave_complex_banded(strips, offs)
    rdt = to_numpy_dtype(dtype)
    if np.issubdtype(rdt, np.complexfloating):
        rdt = np.dtype(np.float64 if rdt == np.complex128 else np.float32)
    if mode is None:
        mode = "lu" if rdt == np.float64 else "inv"
    # factor-cost selection: SPIKE's batched dense blocks cost p (N/p)^3;
    # for wide bands the block-Thomas Schur recursion costs N b^2.  Biased
    # 16x toward SPIKE (its per-solve path is parallel, block-Thomas pays
    # 2 nblk sequential steps); the unpivoted Schur recursion is kept to
    # float64 ('lu') runs.
    N = rstrips.shape[1]
    b = max((abs(o) for o in roffs), default=1)
    blk = -(-N // p)
    spike_flops = p * blk**3 + (2 * b * p) ** 3
    thomas_flops = 4 * N * b * b
    if 16 * thomas_flops < spike_flops and mode == "lu":
        base = BlockTridiagSolver(rstrips.astype(rdt), roffs, mode=mode,
                                  device=device)
    else:
        base = PartitionedBandedSolver(rstrips.astype(rdt), roffs, p=p,
                                       mode=mode, device=device)
    if Lc is None:
        return InterleavedSMW(base)
    with trace.span("nt.factorize.smw", device=device.type == "cuda"):
        Lh, Uh = complex_lowrank_to_half(Lc, Uc)
        trace.count("nt.factorize.smw_rank", Lh.shape[1])
        tdt = to_torch_dtype(rdt)
        return InterleavedSMW(
            base, torch.from_numpy(Lh).to(device=device, dtype=tdt),
            torch.from_numpy(Uh).to(device=device, dtype=tdt))


class ShiftPlan:
    """Structure-frozen shift assembly.

    The STRUCTURE of M(sigma) — which terms are low-rank, the band offsets,
    the arrow border — depends only on the sparsity patterns, so this plan
    computes it once over the union bulk pattern and then produces
    ``(strips, offsets, Lc, Uc)`` for any sigma by weight contraction
    (host numpy, O(nnz) per shift)."""

    def __init__(self, mats, fv, max_rank=None):
        import scipy.sparse as sp

        from ..models.lowrank import low_rank_factors

        seq = [sp.csr_matrix(A) if not sp.issparse(A) else A.tocsr()
               for A in mats]
        n = seq[0].shape[0]
        self.n = n
        self.fv = fv
        self._on_device = {}  # device -> _PlanOnDevice, built on first use
        if max_rank is None:
            max_rank = max(32, n // 64)
        self.lr = []  # (term index, L, Uc) with A_i = L @ Uc^T
        bulk_idx = []
        bulk_elim = []  # zero-eliminated copies: union and per-term data
        union = None    # must both use the eliminated patterns
        for i, A in enumerate(seq):
            if A.nnz == 0:
                continue
            # classification stays on the as-given pattern
            if _support(A) <= max_rank:
                L, U = low_rank_factors(A)
                self.lr.append((i, np.asarray(L).astype(complex),
                                np.conj(np.asarray(U)).astype(complex)))
            else:
                bulk_idx.append(i)
                B = A.copy()
                B.eliminate_zeros()
                B.sum_duplicates()
                bulk_elim.append(B)
                P = sp.csr_matrix((np.abs(B.data), B.indices, B.indptr),
                                  shape=B.shape)
                union = P if union is None else union + P
        self.bulk_idx = bulk_idx
        self.ok = True
        if union is None:  # no bulk: the banded base would be singular
            self.ok = False
            return
        union = union.tocsr()
        union.sum_duplicates()
        split = arrow_split(union, max_rank)
        if split is None:
            self.ok = False
            return
        band_u, factors_u = split
        self.m = factors_u[0][1].shape[1] if factors_u else 0
        coo_u = band_u.tocoo()
        offs = np.unique(coo_u.col - coo_u.row)
        if 0 not in offs:
            offs = np.sort(np.append(offs, 0))
        self.offsets = tuple(int(o) for o in offs)
        self.b = max((abs(o) for o in self.offsets), default=0)
        m = self.m
        U = union.tocoo()
        key_u = U.row.astype(np.int64) * n + U.col
        nnz_u = len(key_u)
        self.data_stack = np.zeros((len(bulk_idx), nnz_u), dtype=complex)
        for t, A in enumerate(bulk_elim):
            coo = A.tocoo()
            key_i = coo.row.astype(np.int64) * n + coo.col
            pos = np.searchsorted(key_u, key_i)
            if len(key_i) and (pos.max() >= nnz_u
                               or not np.array_equal(key_u[pos], key_i)):
                raise AssertionError(
                    "bulk term pattern escaped the union pattern")
            self.data_stack[t, pos] = coo.data
        # frozen scatter maps: union position -> band strip slot / border
        d = U.col - U.row
        inband = np.abs(d) <= self.b
        ib = inband.nonzero()[0]
        self._ib_pos = ib
        self._band_slot = np.searchsorted(self.offsets, d[ib])
        self._band_row = U.row[ib]
        if m:
            wide = (~inband).nonzero()[0]
            col_b = U.col[wide] >= n - m
            w1 = wide[col_b]                      # border columns -> X1
            self._x1_pos = w1
            self._x1_rc = (U.row[w1], U.col[w1] - (n - m))
            w2 = wide[~col_b]                     # border rows -> Y2^T
            self._y2_pos = w2
            self._y2_rc = (U.col[w2], U.row[w2] - (n - m))

    def parts(self, sigma):
        """(strips, offsets, Lc, Uc) of M(sigma) — same contract as
        :func:`assemble_shift_parts`."""
        from ..solvers.spmf_real import spmf_fun_scalars

        if not self.ok:
            return None
        w = spmf_fun_scalars(self.fv, sigma)
        wb = w[self.bulk_idx] if self.bulk_idx else np.zeros(0, complex)
        n, m = self.n, self.m
        strips = np.zeros((len(self.offsets), n), dtype=complex)
        if len(wb):
            data = wb @ self.data_stack            # (nnz_u,) complex
            np.add.at(strips, (self._band_slot, self._band_row),
                      data[self._ib_pos])
        Ls = [w[i] * L for i, L, _ in self.lr]
        Us = [U for _, _, U in self.lr]
        if m:
            sel = np.zeros((n, m), dtype=complex)
            sel[n - m:, :] = np.eye(m)
            X1 = np.zeros((n, m), dtype=complex)
            Y2 = np.zeros((n, m), dtype=complex)
            if len(wb):
                X1[self._x1_rc] = data[self._x1_pos]
                Y2[self._y2_rc] = data[self._y2_pos]
            if np.any(X1):
                Ls.append(X1)
                Us.append(sel)
            if np.any(Y2):
                Ls.append(sel)
                Us.append(Y2)
        Lc = np.hstack(Ls) if Ls else None
        Uc = np.hstack(Us) if Us else None
        return strips, list(self.offsets), Lc, Uc

    def on_device(self, device):
        """The plan's :class:`_PlanOnDevice` on ``device``, uploaded the
        first time it is asked for and kept with the plan."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = _PlanOnDevice(self, device)
        return self._on_device[key]


class _PlanOnDevice:
    """A :class:`ShiftPlan` held on one device: the bulk terms' values over
    the union pattern, the low-rank terms' factors and the frozen scatter
    maps into the row-interleaved real operands of :class:`BatchedShiftSMW`.

    :meth:`operands` fills the operands of a whole batch of shifts on the
    device from the (S, terms) weights alone: one complex128 contraction
    ``W @ data_stack`` and fixed-index scatters, the values
    :meth:`ShiftPlan.parts` + :func:`~neptpu_torch.parallel.spike.
    interleave_complex_banded` + :func:`complex_lowrank_to_half` give.  The
    border blocks the halves hold are decided from the union pattern once
    (X1 where border columns carry entries, ``sel`` against Y2 where border
    rows do).  Every host-to-device copy is one copy of a tensor, counted
    in ``nt.refine.chip.upload_bytes``."""

    def __init__(self, plan, device):
        self.device, self.fv = device, plan.fv
        self.n, self.m = n, m = plan.n, plan.m
        offs = plan.offsets
        # the interleaved offsets, as interleave_complex_banded orders them
        roffs = sorted({2 * d + s for d in offs for s in (-1, 0, 1)})
        self.offsets = tuple(roffs)
        slot = {o: j for j, o in enumerate(roffs)}
        self.nbytes = 0
        T, nnz_u = plan.data_stack.shape
        flat = np.flatnonzero(plan.data_stack)
        ds = torch.zeros(T * nnz_u, dtype=torch.complex128, device=device)
        ds[self._put(flat)] = self._put(plan.data_stack.ravel()[flat])
        self.data_stack = ds.view(T, nnz_u)
        self.bulk_idx = np.asarray(plan.bulk_idx, dtype=np.int64)
        # a complex band entry z at (slot j, row r), offset d: Re z at real
        # offset 2d on rows 2r and 2r + 1, -Im z at 2d + 1 on row 2r, Im z
        # at 2d - 1 on row 2r + 1
        lut = np.array([[slot[2 * d], slot[2 * d], slot[2 * d + 1],
                         slot[2 * d - 1]] for d in offs], dtype=np.int64)
        r2 = 2 * plan._band_row.astype(np.int64)
        self.band = (self._put(plan._ib_pos.astype(np.int64)),
                     self._put(lut[plan._band_slot].ravel()),
                     self._put(np.stack([r2, r2 + 1, r2, r2 + 1], 1).ravel()))
        R = 0
        self.lr_terms = np.zeros(0, dtype=np.int64)
        self.lr = None
        if plan.lr:
            self.lr_terms = np.concatenate(
                [np.full(L.shape[1], i) for i, L, _ in plan.lr])
            self.lr = (self._put(np.hstack([L for _, L, _ in plan.lr])),
                       self._put(np.hstack([U for _, _, U in plan.lr])))
            R = len(self.lr_terms)
        self.x1 = self.y2 = None
        if m and len(plan._x1_pos):       # border columns -> [X1 | sel]
            r, c = plan._x1_rc
            self.x1 = (R, self._put(plan._x1_pos.astype(np.int64)),
                       self._put(2 * r.astype(np.int64)),
                       self._put(R + c.astype(np.int64)))
            R += m
        if m and len(plan._y2_pos):       # border rows -> [sel | Y2]
            r, c = plan._y2_rc
            self.y2 = (R, self._put(plan._y2_pos.astype(np.int64)),
                       self._put(2 * r.astype(np.int64)),
                       self._put(R + c.astype(np.int64)))
            R += m
        self.R = R
        trace.count("nt.refine.chip.upload_bytes", self.nbytes)

    def _put(self, x):
        x = np.ascontiguousarray(x)
        self.nbytes += x.nbytes
        return torch.from_numpy(x).to(self.device)

    def batch(self, sigmas, p, ir, dtype):
        """Every operand of a batch of shifts, filled on the device:
        ``(layout, strips, band, Lh, Uh)``.  ``layout = (p, blk, b, nblk)``:
        ``p`` halved until a partition of ``blk`` rows covers the
        half-bandwidth ``b``, and ``nblk`` block-tridiagonal blocks of ``b``
        rows.  ``strips`` (S,
        offsets, p blk) in float32 where ``ir`` is set, else ``dtype``, with
        an identity tail past row 2n that keeps the partitions regular;
        ``band`` and the halves as :meth:`operands` gives them, the band at
        least nblk bt wide where ``ir`` is set."""
        from ..solvers.spmf_real import spmf_fun_scalars

        W = np.stack([spmf_fun_scalars(self.fv, sg) for sg in sigmas])
        n2 = 2 * self.n
        b = max(max((abs(o) for o in self.offsets), default=1), 1)
        p = int(p)
        blk = -(-n2 // p)
        while blk < b:
            p = max(p // 2, 1)
            blk = -(-n2 // p)
        nblk = -(-n2 // b)
        band, Lh, Uh = self.operands(
            W, max(p * blk, nblk * b) if ir else p * blk)
        strips = band[..., :p * blk].to(torch.float32 if ir else dtype,
                                        copy=True).contiguous()
        strips[:, self.offsets.index(0), n2:] = 1.0
        return (p, blk, b, nblk), strips, band, Lh, Uh

    def operands(self, W, width):
        """The float64 operands of a batch from its (S, terms) complex128
        weights ``W`` (host): the interleaved band (S, offsets, width),
        zero past row 2n, and the SMW halves ``Lh``, ``Uh`` (S, 2n, R); one
        zero column where the plan has no low-rank part."""
        S, n, m = len(W), self.n, self.m
        dev, f64 = self.device, torch.float64
        W = np.ascontiguousarray(np.hstack([W[:, self.bulk_idx],
                                            W[:, self.lr_terms]]))
        trace.count("nt.refine.chip.upload_bytes", W.nbytes)
        Wd = torch.from_numpy(W).to(dev)
        nb = len(self.bulk_idx)
        data = Wd[:, :nb] @ self.data_stack            # (S, union), complex
        ib, rslot, rcol = self.band
        z = data.index_select(1, ib)
        re, im = z.real, z.imag
        band = torch.zeros((S, len(self.offsets), width), dtype=f64,
                           device=dev)
        band[:, rslot, rcol] = torch.stack([re, re, -im, im],
                                           dim=-1).reshape(S, -1)
        Lh = torch.zeros((S, 2 * n, max(self.R, 1)), dtype=f64, device=dev)
        Uh = torch.zeros_like(Lh)
        if self.lr is not None:
            L, U = self.lr
            k = U.shape[1]
            Lw = L * Wd[:, nb:].unsqueeze(1)            # w_i L_i, (S, n, k)
            Lh[:, 0::2, :k] = Lw.real
            Lh[:, 1::2, :k] = Lw.imag
            Uh[:, 0::2, :k] = U.real
            Uh[:, 1::2, :k] = -U.imag
        sel = 2 * torch.arange(n - m, n, device=dev)
        ar = torch.arange(m, device=dev)
        if self.x1 is not None:
            c0, pos, r2, c = self.x1
            x = data.index_select(1, pos)
            Lh[:, r2, c] = x.real
            Lh[:, r2 + 1, c] = x.imag
            Uh[:, sel, c0 + ar] = 1.0
        if self.y2 is not None:
            c0, pos, r2, c = self.y2
            y = data.index_select(1, pos)
            Lh[:, sel, c0 + ar] = 1.0
            Uh[:, r2, c] = y.real
            Uh[:, r2 + 1, c] = -y.imag
        return band, Lh, Uh


def _banded_mv64(D64, B64, C64, x, nblk, bt, n2):
    """y = B x in float64 through the BLOCK-TRIDIAGONAL form (block size bt =
    half-bandwidth): stores only 3 n2 bt entries — the memory-optimal
    dense-block representation of the band (a (p, n2/p) partition block form
    is mostly zeros).  x (..., n2, k) against blocks (..., nblk, bt, bt)."""
    lead, k = tuple(x.shape[:-2]), x.shape[-1]
    xp = torch.zeros(lead + (nblk * bt, k), dtype=x.dtype, device=x.device)
    xp[..., :n2, :] = x
    xb = xp.reshape(lead + (nblk, bt, k))
    y = D64 @ xb
    y[..., :-1, :, :] += B64[..., :-1, :, :] @ xb[..., 1:, :, :]
    y[..., 1:, :, :] += C64[..., 1:, :, :] @ xb[..., :-1, :, :]
    return y.reshape(lead + (nblk * bt, k))[..., :n2, :]


#: canonical shift-batch sizes of the JAX package (there every distinct batch
#: size compiles its own programs); the port keeps the table because
#: ``newton_refine`` sizes its memory-aware chunks by it
BATCH_SIZES = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64)


def canonical_batch(k):
    """Smallest canonical batch size >= k (k itself past the table)."""
    for c in BATCH_SIZES:
        if c >= k:
            return c
    return int(k)


class BatchedShiftSMW:
    """A BATCH of :class:`InterleavedSMW` solvers, one per shift, factored
    together: every factor carries a leading shift axis S, so the setup is
    batched ``torch.linalg`` factorizations over S x p partition blocks and
    each solve a handful of batched GEMMs.

    ``solve_pairs(Rre, Rim)``: (n, S) split-channel right-hand sides, pair
    ``j`` solved against shift ``j``'s factorization (the per-eigenvalue
    Newton-refinement contract).

    ``ir > 0`` is the mixed-precision path: float32 block factorization,
    float64 iterative refinement of the banded base solves against the
    block-tridiagonal float64 form of the band, float64 SMW operands and a
    float64 capacitance inverse — float64-quality solves from a float32
    factorization.  (The JAX package pads the shift batch to canonical sizes
    for its compile cache; eager PyTorch compiles nothing per shape, so the
    batch is taken as given.)

    The operands of every shift are filled on ``device`` at once, from the
    plan's device form (:meth:`ShiftPlan.on_device`) and the shifts'
    weights."""

    def __init__(self, mats, fv, sigmas, dtype=torch.float32, p=8,
                 mode="inv", plan=None, refine=1, ir=0, device=None):
        device = resolve_device(device)
        on_card = device.type == "cuda"
        sigmas = np.asarray(sigmas)
        self.S_real = len(sigmas)
        rdt = to_numpy_dtype(dtype)
        if np.issubdtype(rdt, np.complexfloating):
            rdt = np.dtype(np.float64 if rdt == np.complex128 else np.float32)
        tdt = to_torch_dtype(rdt)
        with trace.span("nt.refine.chip.assemble"):
            if plan is None:
                plan = ShiftPlan(mats, fv)
            if not plan.ok:
                raise ValueError(
                    "bulk is neither banded nor arrow-splittable")
            form = plan.on_device(device)
            (p, blk, b, nblk), strips, band, Lh, Uh = form.batch(
                sigmas, p, ir, tdt)
        offsets, n2, bt = form.offsets, 2 * plan.n, b
        self.aux = (offsets, p, blk, b, n2, mode)
        self.refine = int(refine)
        self.ir = int(ir)
        self.n = plan.n
        self.device = device

        if self.ir:
            # float32 factors; the block-tridiagonal float64 form of the band
            # serves the refinement residuals (the dense float32 partition
            # blocks are dropped: this path never calls the float32 matvec)
            with trace.span("nt.refine.chip.factor", device=on_card):
                fac, piv, V, W, r_fac, r_piv, _ = _factor_partitioned(
                    strips, offsets, p, blk, b, mode)
                self.base = PartitionedBandedSolver.from_factors(
                    fac, piv, V, W, r_fac, r_piv, strips,
                    (None, None, None), offsets, p, blk, b, n2, mode)
                self.btdims = (nblk, bt)
                self.D64, self.B64, self.C64 = _assemble_DBC(
                    band[..., :nblk * bt], offsets, nblk, bt, bt, bt)
                del band
                self.Lh64, self.Uh64 = Lh, Uh
            with trace.span("nt.refine.chip.smw", device=on_card):
                self.X64 = self._bsolve64(self.Lh64)
                # K inherits the GLOBAL conditioning of M(sigma) (near an
                # eigenvalue kappa(K) ~ 1/dist), so it is inverted in float64
                self.Kinv64 = torch.linalg.inv(_smw_K(self.X64, self.Uh64))
            return
        with trace.span("nt.refine.chip.factor", device=on_card):
            fac, piv, V, W, r_fac, r_piv, DBC = _factor_partitioned(
                strips, offsets, p, blk, b, mode)
            base = PartitionedBandedSolver.from_factors(
                fac, piv, V, W, r_fac, r_piv, strips, DBC, offsets, p, blk,
                b, n2, mode)
        with trace.span("nt.refine.chip.smw", device=on_card):
            self.smw = InterleavedSMW(base, Lh.to(tdt), Uh.to(tdt),
                                      refine=self.refine)

    def _bsolve64(self, f):
        """Banded base solve to float64 accuracy: float32 SPIKE solve +
        ``ir`` residual corrections against the float64 band."""
        nblk, bt = self.btdims
        n2 = self.aux[4]
        x = self.base.solve(f.to(torch.float32)).to(torch.float64)
        for _ in range(max(self.ir, 1)):
            r = f - _banded_mv64(self.D64, self.B64, self.C64, x, nblk, bt,
                                 n2)
            x = x + self.base.solve(r.to(torch.float32)).to(torch.float64)
        return x

    def _ut_pair64(self, x):
        return torch.cat([self.Uh64.mT @ x,
                          -(self.Uh64.mT @ _rows_rot_i(x))], dim=-2)

    def _full_solve64(self, f):
        R = self.X64.shape[-1]
        g = self._bsolve64(f)
        u = self.Kinv64 @ self._ut_pair64(g)
        return (g - self.X64 @ u[..., :R, :]
                - _rows_rot_i(self.X64 @ u[..., R:, :]))

    def _full_mv64(self, x):
        nblk, bt = self.btdims
        R = self.Lh64.shape[-1]
        t = self._ut_pair64(x)
        return (_banded_mv64(self.D64, self.B64, self.C64, x, nblk, bt,
                             self.aux[4])
                + self.Lh64 @ t[..., :R, :]
                + _rows_rot_i(self.Lh64 @ t[..., R:, :]))

    def solve_pairs(self, Rre, Rim):
        """Per-pair shifted solves: column j against shift j.  Rre/Rim:
        (n, S) arrays or tensors; returns float64 numpy ``(xre, xim)`` of the
        same shape.  With ``ir`` set the result carries float64-quality
        accuracy from the float32 factorization (one full-system float64
        refinement sweep on top of the refined base solves)."""
        dt = torch.float64 if self.ir else self.smw.X.dtype
        Rre = torch.as_tensor(np.asarray(Rre)).to(device=self.device,
                                                  dtype=dt)
        Rim = torch.as_tensor(np.asarray(Rim)).to(device=self.device,
                                                  dtype=dt)
        if Rre.shape[1] != self.S_real:
            raise ValueError(
                f"expected {self.S_real} RHS columns, got {Rre.shape[1]}")
        # (n, S) channel pair -> interleaved (S, 2n, 1), one system per shift
        f = torch.stack([Rre.T, Rim.T], dim=2).reshape(self.S_real, -1, 1)
        if self.ir:
            x = self._full_solve64(f)
            x = x + self._full_solve64(f - self._full_mv64(x))
        else:
            x = self.smw.solve(f)
        x2 = x.reshape(self.S_real, -1, 2).to(torch.float64).cpu().numpy()
        return x2[:, :, 0].T, x2[:, :, 1].T


def arrow_split(A, max_rank):
    """Split a sparse matrix into ``band + exact low-rank border``.

    Returns ``(band_csr, [(Lc, Uc), ...])`` with ``A == band_csr + sum
    Lc Uc^T``, or ``None`` when no such split is economical.  Handles a
    genuinely banded matrix (empty border list) and an arrow (banded except
    the last ``m <= 2 max_rank`` rows/columns, which become exact rank-m
    factors: dense column block x 0/1 selector).  The bandwidth is chosen
    over the distinct offset magnitudes to minimize band + border cost."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    coo = A.tocoo()
    d = coo.col - coo.row
    absd = np.abs(d)
    cands = []  # (cost, b, m)
    for b in np.unique(absd):
        wide = absd > b
        if not wide.any():
            m = 0
        else:
            m = int(n - np.minimum.reduce(
                np.maximum(coo.row[wide], coo.col[wide])))
            if m > 2 * max_rank:
                continue
        cands.append(((2 * int(b) + 1) + 4 * m, int(b), m))
        if m == 0:
            break  # larger b only adds band cost
    # cheapest first: a candidate can fail the arrow check while a wider
    # bandwidth still passes it
    for _, b, m in sorted(cands):
        if m == 0:
            return A, []
        inband = absd <= b
        rest = sp.coo_matrix(
            (coo.data[~inband], (coo.row[~inband], coo.col[~inband])),
            shape=A.shape).tocsr()
        rest2 = rest[:, : n - m].tocoo()
        if (rest2.row < n - m).any():
            continue  # not an arrow at this bandwidth
        band = sp.coo_matrix(
            (coo.data[inband], (coo.row[inband], coo.col[inband])),
            shape=A.shape).tocsr()
        sel = np.zeros((n, m), dtype=coo.data.dtype)
        sel[n - m:, :] = np.eye(m)
        X1 = np.asarray(rest[:, n - m:].todense())
        Y2 = np.zeros((n, m), dtype=coo.data.dtype)
        Y2[rest2.col, rest2.row - (n - m)] = rest2.data
        factors = []
        if np.any(X1):
            factors.append((X1, sel))
        if np.any(Y2):
            factors.append((sel, Y2))
        return band, factors
    return None


def band_border_split(A, max_rank):
    """:func:`arrow_split` in strip form: ``(strips, offsets, [Lc...],
    [Uc...])`` or ``None``."""
    split = arrow_split(A, max_rank)
    if split is None:
        return None
    band, factors = split
    strips, offs = csr_to_strips(band)
    return (strips, offs, [f[0].astype(complex) for f in factors],
            [f[1].astype(complex) for f in factors])
