"""Shared solver conventions: every protocol solver takes
``(nep; dtype, errmeasure, tol, maxit, lam, v, logger, linsolvercreator, ...,
device)``, raises NoConvergenceException carrying partial results, and
returns ``(lam, v)`` or ``(lams, V)``.

Eigenvalue iterates are host scalars (Python ``float``/``complex``); vectors
are tensors on the solver's device.  ``device=None`` is the card; the problem
must live on the device the solver runs on.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of, resolve_device, to_torch_dtype
from ..core.errmeasure import estimate_error, make_errmeasure
from ..core.exceptions import NoConvergenceException
from ..core.logger import parse_logger

__all__ = [
    "default_tol",
    "armijo_rule",
    "closest_to",
    "init_vec",
    "setup_solver",
    "solver_device",
    "scalar_as",
    "vec_as",
    "NoConvergenceException",
]


def default_tol(dtype):
    """100*eps(real(T)) — the Newton-family default."""
    return 100 * float(torch.finfo(real_of(dtype)).eps)


def nep_device(nep):
    """The device a problem's operands live on (``None`` if it holds no
    term bank or device the port knows of)."""
    bank = getattr(nep, "bank", None)
    if bank is not None:
        return torch.device(bank.device)
    if isinstance(getattr(nep, "device", None), torch.device):
        return nep.device  # a problem holding its own operands (WEP_FD)
    for part in ("nep1", "orgnep"):
        if hasattr(nep, part):
            return nep_device(getattr(nep, part))
    return None


def solver_device(nep, device=None):
    """The device a solver runs on: ``device``, or the card.  Raises if the
    problem lives elsewhere — nothing is moved silently."""
    device = resolve_device(device)
    have = nep_device(nep)
    if have is not None and have.type != device.type:
        raise ValueError(
            f"the problem's operands are on {have} but the solver was asked "
            f"to run on {device}; build the problem with device={device!s} "
            "or pass device= to the solver")
    return have if have is not None else device


def init_vec(v, n, dtype, seed: int = 0, device=None):
    """Starting vector: user-provided or reproducible standard-normal (a
    pinned numpy seed for determinism), in ``dtype`` on ``device``."""
    if v is None:
        v = np.random.default_rng(seed).standard_normal(n)
    if isinstance(v, torch.Tensor):
        return vec_as(v.to(device), dtype)
    return vec_as(torch.as_tensor(np.asarray(v), device=device), dtype)


def setup_solver(nep, dtype, errmeasure, logger):
    """Normalize the common kwargs: (torch dtype, errmeasure object,
    Logger)."""
    dtype = torch.complex128 if dtype is None else to_torch_dtype(dtype)
    return dtype, make_errmeasure(errmeasure, nep), parse_logger(logger)


def scalar_as(lam, dtype):
    """A host scalar of ``dtype``'s kind: the real part when ``dtype`` is
    real (dropping a negligible imaginary part), else a complex."""
    lam = complex(lam)
    return lam if to_torch_dtype(dtype).is_complex else lam.real


def vec_as(x, dtype):
    """Cast a vector to ``dtype``; for a real dtype the (negligible)
    imaginary part is dropped explicitly."""
    dtype = to_torch_dtype(dtype)
    if x.is_complex() and not dtype.is_complex:
        x = x.real
    return x.to(dtype)


def closest_to(lam_vec, lam):
    """Entry of lam_vec closest to lam."""
    lam_vec = np.atleast_1d(np.asarray(lam_vec))
    return lam_vec[np.argmin(np.abs(lam_vec - complex(lam)))]


def armijo_rule(nep, errmeasure, err0, lam, v, dlam, dv, factor, armijo_max):
    """Step-length damping: shrink (dlam, dv) by ``factor`` until the error
    measure decreases."""
    j = 0
    if factor < 1:
        while (
            float(estimate_error(errmeasure, lam + dlam, v + dv)) > float(err0)
            and j < armijo_max
        ):
            j += 1
            dv = dv * factor
            dlam = dlam * factor
    return dlam, dv, j, factor**j
