"""Infinite Arnoldi over padded fixed-``maxit`` buffers, in complex dtype.

The basis lives in a preallocated ``V (m+1 cols, m+1 blocks, n)`` with block
masks, so every step has the same shapes: the Mlincomb over all m+1 blocks
with zero coefficients beyond the live prefix, the shifted solve against one
LU of M(sigma), and a two-pass classical Gram-Schmidt against the whole
stacked basis (dead columns are zero).  The step index ``k`` is a 0-dim
int64 tensor on the device and the coefficient mask a ``torch.where`` on it,
as in the JAX step; the derivative table of the problem's terms at sigma is
made on the host once per scan (:func:`_shift_lincomb`).  Where the JAX
package compiles the m steps into one ``lax.scan``, the port replays one
captured CUDA graph a step on the card
(:mod:`neptpu_torch.solvers.scan_graph`) and loops the same step eagerly on
the CPU, writing into the buffers in place.  Ritz extraction happens once at
the end.

``iar_jitted`` matches ``iar``'s results contract; ``iar_scan_kernel`` is
the raw (basis, Hessenberg) builder.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from .common import init_vec, setup_solver, solver_device
from .scan_graph import StepGraph

__all__ = ["iar_scan_kernel", "iar_jitted"]

_C = torch.complex128


def _delegate(nep):
    """The problem whose Mlincomb ``nep``'s Mlincomb only calls, or None: a
    deflated SPMF's ``spmf`` (``models/deflation.py``), a projected
    problem's ``nep_proj`` (``models/projection.py``)."""
    from ..models.deflation import DeflatedSPMF
    from ..models.projection import Proj_SPMF_NEP

    kind = type(nep).Mlincomb
    if kind is DeflatedSPMF.Mlincomb:
        return nep.spmf
    if kind is Proj_SPMF_NEP.Mlincomb:
        return nep.nep_proj
    return None


def _shift_tables(nep, sigma, alpha, device):
    """``([(bank, table)], c1)`` of a problem whose Mlincomb is a derivative
    table at the shift applied to term banks (a DEP, a PEP, an SPMF over a
    bank, sums of them, and problems whose Mlincomb only calls one of these:
    a deflated SPMF, a projected problem): the tables made on the host over
    the coefficients ``alpha``, and ``c1`` the coefficient of the first
    derivative of a ``-lam I`` term (a DEP's; 0 for the others).  ``None``
    for any other problem."""
    from ..models.dep import DEP
    from ..models.pep import PEP
    from ..models.spmf import SPMF_NEP
    from ..models.sumnep import SPMFSumNEP
    from ..ops import matfun

    inner = _delegate(nep)
    if inner is not None:
        return _shift_tables(inner, sigma, alpha, device)
    kind = type(nep).Mlincomb
    if kind is SPMFSumNEP.Mlincomb:  # SPMFSumNEP's and GenericSumNEP's
        parts = [_shift_tables(p, sigma, alpha, device)
                 for p in (nep.nep1, nep.nep2)]
        if None in parts:
            return None
        return parts[0][0] + parts[1][0], parts[0][1] + parts[1][1]
    if isinstance(nep, DEP) and kind is DEP.Mlincomb:
        like = torch.promote_types(_C, nep.bank.dtype)
        return ([(nep.bank, nep._table(nep._exp_coeffs(
            sigma, len(alpha), alpha, 0), like))], complex(alpha[1]))
    if isinstance(nep, PEP) and kind is PEP.Mlincomb:
        C = nep._coeffs(sigma, len(alpha), alpha, 0)
    elif isinstance(nep, SPMF_NEP) and kind is SPMF_NEP.Mlincomb:
        C = matfun.deriv_table(nep.fv, sigma, torch.as_tensor(alpha))
    else:
        return None
    return [(nep.bank, C.to(device))], 0.0


def _shift_lincomb(nep, sigma, alpha, device):
    """The step's masked Mlincomb at the scan's fixed shift, ``(Y (n, m+1),
    live (m+1,) bool) -> sum_j [live_j] alpha_j M^(j)(sigma) Y[:, j]``, for
    the step's masks (``live_j`` for ``1 <= j <= k``, ``k >= 1``: order 0
    never live, order 1 always).  For the table problems of
    :func:`_shift_tables` it is device work alone: ``live`` selects the
    table's columns, as the JAX step masks ``a``, and a ``-lam I`` term adds
    ``-alpha_1 Y[:, 1]``.  Any other problem goes through its ``Mlincomb``
    each step, which reads the coefficients on the host: that runs in the
    eager loop (a CPU run); on the card its capture fails and raises."""
    from ..models.spmf import _bank_lincomb

    tables = _shift_tables(nep, sigma, alpha, device)
    if tables is None:
        alpha_t = torch.as_tensor(alpha, device=device)

        def generic(Y, live):
            a = torch.where(live, alpha_t, torch.zeros_like(alpha_t))
            return compute_Mlincomb(nep, sigma, Y, a)

        return generic
    terms, c1 = tables

    def apply(Y, live):
        z = None
        for bank, C in terms:
            D = torch.where(live[None, :], C, torch.zeros((), dtype=C.dtype,
                                                          device=device))
            part = _bank_lincomb(bank, Y, D)
            z = part if z is None else z + part
        return z - c1 * Y[:, 1] if c1 else z

    return apply


def _step_fn(m, lincomb, lu, piv, cdt, device):
    """One padded IAR step as ``step(carry, k)`` (the body of the JAX
    package's ``iar_scan_kernel``): ``k`` the 1-based step index, a 0-dim
    int64 tensor on the device; the carry ``(V, H)`` is updated in place.
    Every shape is static and ``k`` is read on the device only."""
    jblk = torch.arange(m + 1, device=device)
    scale_all = 1.0 / (jblk + 1.0).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    lo = jblk >= 1

    def step(carry, k):
        V, H = carry
        n = V.shape[2]
        km1 = (k - 1).view(1)
        # y blocks: y[j+1] = V[k-1 col][j] / (j+1) for j < k
        prev = V.index_select(0, km1)[0]
        scale = torch.where(jblk < k, scale_all, zero).to(cdt)
        y = torch.roll(prev * scale[:, None], 1, dims=0)  # blocks 1..k live
        # masked Mlincomb: alpha[j] for 1 <= j <= k, else 0
        z = lincomb(y.T, lo & (jblk <= k)).to(cdt)
        y[0] = -torch.linalg.lu_solve(lu, piv, z[:, None])[:, 0]

        # DGKS (two-pass CGS) against the stacked basis
        Vmat = V.reshape(m + 1, -1)  # columns as rows: (m+1, n(m+1))
        w = y.reshape(-1)
        h1 = Vmat.conj() @ w
        w = w - Vmat.T @ h1
        h2 = Vmat.conj() @ w
        w = w - Vmat.T @ h2
        h = h1 + h2
        beta = torch.linalg.vector_norm(w)
        V.index_copy_(0, k.view(1), (w / beta).reshape(1, m + 1, n))
        H.index_copy_(1, km1, torch.where(jblk == k, beta.to(cdt), h)[:, None])
        return beta

    return step


def iar_scan_kernel(nep, m, sigma, gamma, v0, lu_piv):
    """Run m IAR steps; returns ``(V, H)``.

    ``V``: ``(m+1 cols, m+1 blocks, n)`` padded basis — column k holds k+1
    live n-blocks; ``H``: ``(m+1, m)`` Hessenberg, both on the device of
    ``v0``.  ``lu_piv``: the ``(lu, piv)`` of M(sigma) (``torch.linalg``
    pivots).  On the card the steps after the first are replays of one
    captured graph."""
    n = v0.shape[0]
    dev = v0.device
    cdt = _C
    lu, piv = lu_piv
    lu = lu.to(cdt)
    sigma, gamma = complex(sigma), complex(gamma)
    alpha = np.array([gamma**j for j in range(m + 1)], dtype=complex)
    step = _step_fn(m, _shift_lincomb(nep, sigma, alpha, dev), lu,
                    piv, cdt, dev)

    V = torch.zeros((m + 1, m + 1, n), dtype=cdt, device=dev)
    v0 = v0.to(cdt)
    V[0, 0] = v0 / torch.linalg.vector_norm(v0)
    H = torch.zeros((m + 1, m), dtype=cdt, device=dev)
    k = torch.ones((), dtype=torch.int64, device=dev)
    with StepGraph(step, (V, H), k) as run:
        run.advance(m)
    return V, H


def iar_jitted(nep, dtype=None, maxit=30, linsolvercreator=None, tol=None,
               neigs=6, errmeasure=None, sigma=0.0, gamma=1.0, v=None,
               logger=0, device=None):
    """IAR with the padded-buffer step loop + Ritz extraction at the end.
    Same contract as ``iar`` (without projected extraction): returns
    ``(lams, Q, V)`` — the converged eigenvalues (numpy), their vectors and
    the padded basis (tensors on the device)."""
    from ..ops.linsolve import create_linsolver

    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 10000 * float(torch.finfo(
            torch.promote_types(real_of(dtype), torch.float32)).eps)
    n = nep.n
    m = maxit
    sigma_c = complex(sigma)
    # one cached factorization of M(sigma) drives all steps
    solver = create_linsolver(linsolvercreator, nep, sigma_c)
    lu_piv = (solver.lu, solver.piv)
    v0 = init_vec(v, n, dtype, device=device).to(_C)

    V, H = iar_scan_kernel(nep, m, sigma_c, complex(gamma), v0, lu_piv)
    Hh = H.cpu().numpy()
    D, Z = np.linalg.eig(Hh[:m, :m])
    lams = sigma_c + complex(gamma) / D
    Q = V[:, 0, :].T[:, :m] @ torch.as_tensor(Z, device=device)
    errs = np.array([float(estimate_error(em, lams[s], Q[:, s]))
                     for s in range(len(lams))])
    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol))
    take = idx[: min(neigs, max(nconv, 0))]
    return (lams[take], Q[:, torch.as_tensor(take, device=device)], V)
