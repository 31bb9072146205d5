"""Block Newton for invariant pairs (Kressner 2009), written against the
compute protocol: Newton on the coupled equations ``compute_MM(S, X) = 0``,
``V(X, S)^H [X; XS; ...] = I``, with Schur-form transformed per-column
correction solves.

The operands are made dense on the solver's device and every n-sized block
lives there: each column of each Newton step solves one dense bordered
``(n + p)^2`` complex system (cuSOLVER on the card).  ``S`` and the p x p
algebra are host numpy."""
from __future__ import annotations

import numpy as np
import torch

from ..core.logger import parse_logger
from ..core.nep import compute_Mder, compute_MM
from ..ops import lapack
from .common import NoConvergenceException, solver_device

__all__ = ["blocknewton"]

_C = torch.complex128


def _Vl(X, S):
    """``[X; X S; X S^2; ...]`` with p block rows (a device tensor)."""
    p = S.shape[0]
    St = torch.as_tensor(S, dtype=_C, device=X.device)
    blocks, B = [], X
    for _ in range(p):
        blocks.append(B)
        B = B @ St
    return torch.cat(blocks, dim=0)


def _dense(M):
    return (M if isinstance(M, torch.Tensor) else M.to_dense()).to(_C)


def blocknewton(nep, S=None, X=None, errmeasure=None, tol=None, maxit=10,
                logger=0, armijo_factor=1.0, armijo_max=5, device=None):
    """Returns the invariant pair ``(S, X)``: ``S (p, p)`` host numpy, ``X
    (n, p)`` a tensor on the device; raises :class:`NoConvergenceException`
    carrying the last pair after ``maxit`` steps.  ``S``, ``X``: the start
    (default zeros(2, 2) and the first two unit vectors); ``errmeasure``:
    ``(S, X) -> float`` (default the spectral norm of ``compute_MM(S, X)``);
    ``armijo_factor < 1`` damps each step.  ``device=None`` is the card."""
    device = solver_device(nep, device)
    lg = parse_logger(logger)
    n = nep.n
    S = np.zeros((2, 2)) if S is None else S
    S = np.asarray(S, dtype=complex)
    p = S.shape[0]
    X = (torch.eye(n, p, dtype=_C, device=device) if X is None
         else torch.as_tensor(X, device=device).to(_C))
    if tol is None:
        tol = 100 * np.finfo(float).eps

    def MM(S_, X_):
        return compute_MM(nep, torch.as_tensor(S_, dtype=_C), X_)

    if errmeasure is None:
        def errmeasure(S_, X_):
            return float(torch.linalg.matrix_norm(MM(S_, X_), ord=2))

    fv = nep.get_fv()
    Av = [_dense(A) for A in nep.get_Av()]
    m = len(fv)

    def f_eval(f, M):
        return f(torch.as_tensor(M, dtype=_C)).numpy()

    def stack_blocks(Wq):
        return torch.stack([Wq[j * n:(j + 1) * n, :] for j in range(p)],
                           dim=2)

    WW = stack_blocks(_Vl(X, S))  # (n, p, l)
    l = p
    err0 = np.inf

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=_C,
                               device=device)

    def newtonstep_linsys(S_, X_, WW_, RT, RV):
        dX = torch.zeros((n, p), dtype=_C, device=device)
        dS = np.zeros((p, p), dtype=complex)
        fS = np.stack([f_eval(f, S_) for f in fv], axis=2)  # (p, p, m)
        RT = RT.clone()
        RV = RV.copy()
        WH = [WW_[:, :, j].conj().T for j in range(l)]
        for i in range(p):
            s = S_[i, i]
            T11 = _dense(compute_Mder(nep, s))
            S_exp = np.block([[S_, np.eye(p)],
                              [np.zeros((p, p)), s * np.eye(p)]])
            T12 = torch.zeros((n, p), dtype=_C, device=device)
            for j in range(m):
                DF = f_eval(fv[j], S_exp)
                T12 += Av[j] @ (X_ @ t_(DF[:p, p:]))
            T21 = WH[0].clone()
            for j in range(1, l):
                T21 += complex(s ** j) * WH[j]
            DS = np.eye(p, dtype=complex)
            T22 = torch.zeros((p, p), dtype=_C, device=device)
            Spow = np.eye(p, dtype=complex)
            for j in range(1, l):
                T22 += WH[j] @ X_ @ t_(DS)
                DS = s * DS + Spow
                Spow = Spow @ S_
            TT = torch.cat([torch.cat([T11, T12], dim=1),
                            torch.cat([T21, T22], dim=1)], dim=0)
            sol = torch.linalg.solve(TT, torch.cat([RT[:, i], t_(RV[:, i])]))
            dX[:, i] = sol[:n]
            dS[:, i] = sol[n:].cpu().numpy()
            if i < p - 1:
                Z = np.zeros((p, p), dtype=complex)
                Z[:, i] = dS[:, i]
                DS2 = Z.copy()
                S2_exp = np.block([[S_, Z], [np.zeros((p, p)), S_]])
                for j in range(m):
                    Za = dX[:, i, None] * t_(fS[i, i + 1:, j])[None, :]
                    DF = f_eval(fv[j], S2_exp)
                    Zb = X_ @ t_(DF[:p, p + i + 1: 2 * p])
                    RT[:, i + 1:] += -(Av[j] @ (Za + Zb))
                Spow2 = np.eye(p, dtype=complex)
                for j in range(1, l):
                    Za = dX[:, i, None] * t_(Spow2[i, i + 1:])[None, :]
                    Zb = X_ @ t_(DS2[:, i + 1:])
                    RV[:, i + 1:] += -(WH[j] @ (Za + Zb)).cpu().numpy()
                    DS2 = DS2 @ S_ + Spow2 @ DS2
                    Spow2 = Spow2 @ S_
        return dS, dX

    for k in range(maxit):
        err0 = errmeasure(S, X)
        lg.iteration(k, errs=err0)
        if err0 < tol:
            return S, X
        Res = MM(S, X)
        RR, QQ = (a.numpy() for a in lapack.schur(torch.from_numpy(S)))
        dSt, dXt = newtonstep_linsys(RR, X @ t_(QQ), WW, Res @ t_(QQ),
                                     np.zeros((p, p), dtype=complex))
        dX = dXt @ t_(QQ.conj().T)
        dS = QQ @ dSt @ QQ.conj().T

        if armijo_factor < 1:
            DS, DV = -dS, -dX
            j = 0
            while errmeasure(S + DS, X + DV) > err0 and j < armijo_max:
                j += 1
                DS = DS * armijo_factor
                DV = DV * armijo_factor
            St, Xt = S + DS, X + DV
        else:
            St, Xt = S - dS, X - dX

        Wq, R = torch.linalg.qr(_Vl(Xt, St))
        WW = stack_blocks(Wq)
        X = torch.linalg.solve_triangular(R, Xt, upper=True, left=False)
        Rh = R.cpu().numpy()
        S = (Rh @ St) @ np.linalg.inv(Rh)
    raise NoConvergenceException(
        S, X, err0, f"Number of iterations exceeded. maxit={maxit}.")
