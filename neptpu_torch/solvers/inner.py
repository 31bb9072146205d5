"""Inner-outer solver protocol: ``inner_solve(is, dtype, projnep; sigma,
lamv, V, neigs, tol, inner_logger)`` solves the small projected NEP inside
``nlar``, ``jd_*`` and the projected extraction of ``iar``/``tiar``.

The projected problem lives on the host (``models/projection.py``), so the
inner solvers run there; ``inner_solve`` returns host numpy arrays
``(lamv, V)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import ResidualErrmeasure
from ..core.exceptions import NoConvergenceException
from ..models.dep import DEP
from ..models.pep import PEP
from ..models.spmf import SPMF_NEP
from ..ops.sparse import DenseTermBank
from .common import nep_device

__all__ = [
    "InnerSolver",
    "DefaultInnerSolver",
    "NewtonInnerSolver",
    "PolyeigInnerSolver",
    "IARInnerSolver",
    "IARChebInnerSolver",
    "SGIterInnerSolver",
    "ContourBeynInnerSolver",
    "NleigsInnerSolver",
    "inner_solve",
    "inner_solve_rf",
]


class InnerSolver:
    pass


class DefaultInnerSolver(InnerSolver):
    pass


class NewtonInnerSolver(InnerSolver):
    def __init__(self, tol=1e-13, maxit=80, starting_vector=":Vk",
                 newton_function=None):
        self.tol = tol
        self.maxit = maxit
        self.starting_vector = starting_vector
        if newton_function is None:
            from .newton import augnewton

            newton_function = augnewton
        self.newton_function = newton_function


class PolyeigInnerSolver(InnerSolver):
    pass


class IARInnerSolver(InnerSolver):
    def __init__(self, tol=1e-13, maxit=80, starting_vector=":ones",
                 normalize_DEPs=":auto", iar_function=None):
        self.tol = tol
        self.maxit = maxit
        self.starting_vector = starting_vector
        self.normalize_DEPs = normalize_DEPs
        if iar_function is None:
            from .iar import iar

            iar_function = iar
        self.iar_function = iar_function


class IARChebInnerSolver(IARInnerSolver):
    """Chebyshev-basis IAR for the inner problem; runs the Taylor IAR, as the
    JAX package's does (its ``iar_chebyshev`` is not wired in here; the
    projected problems are analytic near the shift, where the two are
    equivalent)."""


class SGIterInnerSolver(InnerSolver):
    pass


class ContourBeynInnerSolver(InnerSolver):
    def __init__(self, tol=np.sqrt(np.finfo(float).eps), radius=":auto",
                 N=1000):
        self.tol = tol
        self.radius = radius
        self.N = N


class NleigsInnerSolver(InnerSolver):
    def __init__(self, Sigma=":auto", nodes=":auto", tol=1e-6):
        self.Sigma = Sigma
        self.nodes = nodes
        self.tol = tol


def _resolve(is_, nep):
    """``DefaultInnerSolver`` dispatch on the class of ``nep.orgnep``: for a
    projection of a deflated problem that is the deflated SPMF, so it takes
    ``IARInnerSolver``."""
    if is_ is None:
        is_ = DefaultInnerSolver()
    if isinstance(is_, DefaultInnerSolver):
        org = getattr(nep, "orgnep", nep)
        if isinstance(org, PEP):
            return PolyeigInnerSolver()
        if isinstance(org, DEP):
            return IARChebInnerSolver()
        if isinstance(org, SPMF_NEP) or hasattr(org, "get_fv"):
            return IARInnerSolver()
        return NewtonInnerSolver()
    return is_


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dense(A):
    return A if isinstance(A, torch.Tensor) else A.to_dense()


def inner_solve(is_, dtype, nep, lamv=None, V=None, sigma=0.0, neigs=10,
                tol=None, j=0, inner_logger=0):
    """Returns ``(lamv, V)`` (host numpy) for the projected problem."""
    is_ = _resolve(is_, nep)
    n = nep.n
    device = nep_device(nep) or torch.device("cpu")

    if isinstance(is_, PolyeigInnerSolver):
        from .companion import polyeig

        bank = DenseTermBank(torch.stack([_dense(B) for B in nep.get_Av()]))
        D, VV = polyeig(PEP(None, bank=bank), dtype)
        return _host(D), _host(VV)

    if isinstance(is_, IARInnerSolver):
        v0 = (np.ones(n) if is_.starting_vector == ":ones"
              else np.random.default_rng(0).standard_normal(n))
        try:
            # NOTE: the Krylov degree of an infinite-Arnoldi run may exceed
            # the problem dimension (the linearization is infinite-
            # dimensional), so small PROJECTED problems must not be capped at
            # 2n steps - that cap silently limited inner accuracy to ~1e-5 on
            # 5-dimensional projections (an inner-solve sweep of the JAX
            # package)
            out = is_.iar_function(
                nep, dtype=dtype, sigma=sigma, neigs=neigs,
                tol=tol if tol is not None else is_.tol,
                maxit=min(is_.maxit, max(2 * n, 40)),
                logger=inner_logger, v=v0, device=device)
            return _host(out[0]), _host(out[1])
        except NoConvergenceException as e:
            return _host(e.lam), _host(e.v)

    if isinstance(is_, NewtonInnerSolver):
        lamv = np.array(np.atleast_1d(np.zeros(1) if lamv is None
                                      else _host(lamv)), dtype=complex)
        V = (np.random.default_rng(0).standard_normal((n, len(lamv)))
             if V is None else _host(V))
        V = np.array(V, dtype=complex)
        errm = ResidualErrmeasure(nep)
        for k in range(len(lamv)):
            if is_.starting_vector == ":ones":
                v0 = np.ones(n)
            elif is_.starting_vector == ":randn":
                v0 = np.random.default_rng(k).standard_normal(n)
            else:
                v0 = V[:, k]
            try:
                lam1, vproj = is_.newton_function(
                    nep, dtype=dtype, logger=inner_logger, lam=lamv[k], v=v0,
                    maxit=is_.maxit, tol=is_.tol, errmeasure=errm,
                    device=device)
                V[:, k] = _host(vproj)
                lamv[k] = complex(lam1)
            except NoConvergenceException as e:
                if e.v is not None:
                    V[:, k] = _host(e.v).reshape(-1)[:n]
                if e.lam is not None:
                    lamv[k] = complex(np.atleast_1d(_host(e.lam))[0])
        return lamv, V

    if isinstance(is_, SGIterInnerSolver):
        from .sgiter import sgiter

        lam, v = sgiter(nep, j if j > 0 else 1, dtype=dtype,
                        logger=inner_logger, device=device)
        return np.array([complex(lam)]), _host(v)[:, None]

    if isinstance(is_, ContourBeynInnerSolver):
        from .contour import contour_beyn

        lamv = np.atleast_1d(_host(lamv if lamv is not None else [0, 1]))
        if isinstance(is_.radius, str):  # ":auto"
            radius = float(np.max(np.abs(sigma - lamv))) * 1.5 + 1e-8
        else:
            radius = is_.radius
        k = int(min(neigs, n - 1)) if n > 1 else 1
        lams, V_ = contour_beyn(nep, dtype=dtype, neigs=k, sigma=sigma,
                                radius=radius, N=is_.N, tol=is_.tol,
                                sanity_check=False, logger=inner_logger,
                                device=device)
        return np.asarray(lams), _host(V_)

    if isinstance(is_, NleigsInnerSolver):
        from .nleigs import nleigs

        lamv = np.atleast_1d(np.asarray(
            _host(lamv) if lamv is not None else [0, 1], dtype=complex))
        if isinstance(is_.Sigma, str):  # ":auto"
            sg = np.mean(lamv)
            r = float(np.max(np.abs(sg - lamv))) * 1.5 + 1e-8
            th = np.linspace(0, 2 * np.pi, 1000)
            Sigma = sg + r * np.exp(1j * th)
        else:
            Sigma = is_.Sigma
        nodes = [0.0 + 0.0j] if isinstance(is_.nodes, str) else is_.nodes
        lams, V_, _, _ = nleigs(nep, Sigma, nodes=nodes,
                                tol=tol if tol is not None else is_.tol,
                                static=True, device=device)
        return np.asarray(lams), _host(V_)

    raise ValueError(f"unknown inner solver {is_}")


def inner_solve_rf(dtype, nep, x, inner_solver, y=None, target=0.0, lam=None):
    """``compute_rf`` through the 1 x 1 projected NEP ``y^H M(lam) x`` and
    an InnerSolver: its eigenvalues sorted by distance to ``target``."""
    from ..models.projection import create_proj_NEP

    y = x if y is None else y
    pnep = create_proj_NEP(nep, 1)
    pnep.set_projectmatrices((y / torch.linalg.vector_norm(y))[:, None],
                             (x / torch.linalg.vector_norm(x))[:, None])
    lams, _ = inner_solve(inner_solver, dtype, pnep,
                          lamv=np.array([lam if lam is not None else target]),
                          sigma=target, neigs=1)
    lams = np.atleast_1d(np.asarray(lams))
    return lams[np.argsort(np.abs(lams - complex(target)))]
