"""Bridge to the Berlin-Manchester NLEVP MATLAB toolbox: an opt-in
cross-validation layer through the ``matlab.engine`` Python package; without
it a clear error points at the native reimplementations
(``nlevp_native_*``)."""
from __future__ import annotations

import os

import numpy as np
import torch

from ...config import resolve_device
from ...core.nep import NEP, mlincomb_from_mder

__all__ = ["NLEVP_NEP", "nlevp_gallery_import"]


class NLEVP_NEP(NEP):
    """A problem whose compute functions evaluate through the NLEVP
    toolbox's ``funs`` cell."""

    def __init__(self, name, engine, n, device=None):
        self.name = name
        self.engine = engine
        self.n = n
        self.device = resolve_device(device)

    def Mder(self, lam, der: int = 0):
        if der > 0:
            raise NotImplementedError(
                "derivatives through the MATLAB bridge use FD")
        coeffs, fvals = self.engine.nlevp("eval", self.name, complex(lam),
                                          nargout=2)
        A = np.zeros((self.n, self.n), dtype=complex)
        fvals = np.atleast_2d(np.asarray(fvals))
        for i in range(fvals.shape[1]):
            A += np.asarray(coeffs[i]) * complex(fvals[0, i])
        return torch.as_tensor(A, device=self.device)

    Mder_dense = Mder

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mder(self, lam, V, a, startder)


def nlevp_gallery_import(name, nlevp_path=None, device=None):
    """Construct an NLEVP problem through the MATLAB engine."""
    nlevp_path = nlevp_path or os.environ.get("NLEVP_PATH")
    try:
        import matlab.engine  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "The NLEVP bridge needs the 'matlab.engine' package and a MATLAB "
            "installation (and NLEVP_PATH). Use the native implementations "
            "instead: nep_gallery('nlevp_native_<name>').") from e
    if not nlevp_path or not os.path.exists(nlevp_path):
        raise FileNotFoundError(
            "Set NLEVP_PATH to the NLEVP toolbox directory.")
    eng = matlab.engine.start_matlab()
    eng.addpath(nlevp_path)
    coeffs = eng.nlevp("eval", name, 0.0 + 0.0j, nargout=2)[0]
    n = np.asarray(coeffs[0]).shape[0]
    return NLEVP_NEP(name, eng, n, device=device)
