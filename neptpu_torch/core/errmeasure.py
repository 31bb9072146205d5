"""Error-measure strategy objects.

``estimate_error(errm, lam, v)`` returns the convergence measure a solver
iterates on, as a Python float.  ``DefaultErrmeasure`` picks the backward
error for SPMF problems and the plain relative residual otherwise; a bare
callable ``(lam, v) -> err`` is accepted anywhere an Errmeasure is.  The
measures run eagerly on the device of ``v``.
"""
from __future__ import annotations

import numpy as np
import torch

from .nep import compute_Mlincomb

__all__ = [
    "Errmeasure",
    "ResidualErrmeasure",
    "StandardSPMFErrmeasure",
    "EigvalReferenceErrmeasure",
    "DefaultErrmeasure",
    "estimate_error",
    "make_errmeasure",
]


class Errmeasure:
    def __call__(self, lam, v):
        raise NotImplementedError


def _norm(x):
    return float(torch.linalg.vector_norm(x))


def _ratio(num, den):
    """``num / den`` with IEEE results (inf, nan) where Python would raise:
    a diverged iterate must reach the solver as a non-finite error, so that
    it ends in NoConvergenceException with the partial results."""
    with np.errstate(all="ignore"):
        return float(np.float64(num) / np.float64(den))


class ResidualErrmeasure(Errmeasure):
    """``||M(lam) v|| / ||v||``."""

    def __init__(self, nep):
        self.nep = nep

    def __call__(self, lam, v):
        return _ratio(_norm(compute_Mlincomb(self.nep, lam, v)), _norm(v))


def _term_norm(A):
    """Frobenius norm of one operand: a dense tensor, a term that knows its
    norm (a low-rank term), or a sparse term whose stored values are
    ``A.data``."""
    if isinstance(A, torch.Tensor):
        return _norm(A)
    fro = getattr(A, "fro_norm", None)
    return float(fro) if fro is not None else _norm(A.data)


class StandardSPMFErrmeasure(Errmeasure):
    """Backward error with precomputed Frobenius coefficients:
    ``||M(lam) v|| / (sum_i |f_i(lam)| ||A_i||_F ||v||)``."""

    def __init__(self, nep):
        self.nep = nep
        bank = getattr(nep, "bank", None)
        self.coeffs = (bank.fro_norms.detach().cpu().to(torch.float64)
                       if bank is not None else None)

    def __call__(self, lam, v):
        nep = self.nep
        num = _norm(compute_Mlincomb(nep, lam, v))
        fvals = torch.abs(nep.fv_scalar(lam)).cpu().to(torch.float64)
        if self.coeffs is None or self.coeffs.shape[0] != fvals.shape[0]:
            # the bank does not hold every term (a DEP's -lam*I): norms of
            # the SPMF view's operands, computed once
            self.coeffs = torch.tensor([_term_norm(A) for A in nep.get_Av()],
                                       dtype=torch.float64)
        return _ratio(num,
                      float(torch.sum(fvals * self.coeffs)) * _norm(v))


class EigvalReferenceErrmeasure(Errmeasure):
    """``|lam - lam_ref|``."""

    def __init__(self, nep, lam_ref):
        self.lam_ref = complex(lam_ref)

    def __call__(self, lam, v):
        return abs(complex(lam) - self.lam_ref)


def DefaultErrmeasure(nep):
    from ..models.spmf import AbstractSPMF

    if isinstance(nep, AbstractSPMF):
        return StandardSPMFErrmeasure(nep)
    return ResidualErrmeasure(nep)


def estimate_error(errmeasure, lam, v):
    return errmeasure(lam, v)


def make_errmeasure(errmeasure, nep):
    """Normalize a user-supplied errmeasure argument (None / class /
    callable)."""
    if errmeasure is None:
        return DefaultErrmeasure(nep)
    if isinstance(errmeasure, type):
        return errmeasure(nep)
    return errmeasure
