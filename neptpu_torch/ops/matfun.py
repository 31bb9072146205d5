"""Matrix functions on small dense matrices + derivative tables.

The SPMF contract: each term function ``f`` maps a square tensor ``(k, k)``
to ``f(S)`` as a ``(k, k)`` tensor (matrix-function sense), and must be valid
for *defective* matrices, because the derivative-table trick feeds it
Jordan-chain matrices.

Key trick: for the lower-bidiagonal ``S`` with ``lambda`` on the diagonal and
``s_j = j * a_j / a_{j-1}`` on the subdiagonal, the first column of ``f(S)``
is ``[a_j * f^{(j)}(lambda) / a_0]_j`` — the scaled derivative weights that
``compute_Mlincomb`` needs, with no factorial overflow.  Derivative tables
are computed in complex128 on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DerivFun",
    "with_derivs",
    "eye_like",
    "expm",
    "inv",
    "sqrtm",
    "sinm",
    "cosm",
    "sinhm",
    "coshm",
    "ramp",
    "jordan_matrix",
    "deriv_weights",
    "deriv_table",
    "fun_derivatives",
]


class DerivFun:
    """A matrix function carrying a closed-form host-side derivative table.

    ``__call__(S)`` is the matrix function (the SPMF contract);
    ``derivs(lam, k)`` returns ``[f(lam), f'(lam), ..., f^{(k-1)}(lam)]`` as a
    numpy complex128 array, so coefficient tables are exact in float64 even
    when the scan runs in float32.
    """

    def __init__(self, fn, derivs):
        self._fn = fn
        self._derivs = derivs

    def __call__(self, S):
        return self._fn(S)

    def derivs(self, lam, k):
        return np.asarray(self._derivs(complex(lam), int(k)),
                          dtype=np.complex128)


def with_derivs(fn, derivs):
    """Attach a closed-form derivative rule to a matrix function."""
    return DerivFun(fn, derivs)


def eye_like(S):
    """Identity matching ``S`` (dtype and device; a 0-dim one for scalars)."""
    if S.ndim == 0:
        return torch.ones((), dtype=S.dtype, device=S.device)
    return torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def expm(S):
    """Matrix exponential (scalar-safe)."""
    if S.ndim == 0:
        return torch.exp(S)
    return torch.linalg.matrix_exp(S)


def inv(S):
    """Matrix inverse (scalar-safe)."""
    if S.ndim == 0:
        return 1.0 / S
    return torch.linalg.inv(S)


def _trig_parts(S):
    """``(expm(iS), expm(-iS))`` in the complex dtype of ``S``."""
    Sc = S.to(torch.promote_types(S.dtype, torch.complex64))
    return torch.linalg.matrix_exp(1j * Sc), torch.linalg.matrix_exp(-1j * Sc)


def _real_like(R, S):
    """A real ``S`` gets the real part of ``R`` back in its own dtype."""
    return R.real.to(S.dtype) if S.dtype.is_floating_point else R


def sinm(S):
    """Matrix sine (scalar-safe)."""
    if S.ndim == 0:
        return torch.sin(S)
    E, Em = _trig_parts(S)
    return _real_like((E - Em) / 2j, S)


def cosm(S):
    """Matrix cosine (scalar-safe)."""
    if S.ndim == 0:
        return torch.cos(S)
    E, Em = _trig_parts(S)
    return _real_like((E + Em) / 2, S)


def sinhm(S):
    """Matrix hyperbolic sine (scalar-safe)."""
    if S.ndim == 0:
        return torch.sinh(S)
    return (torch.linalg.matrix_exp(S) - torch.linalg.matrix_exp(-S)) / 2


def coshm(S):
    """Matrix hyperbolic cosine (scalar-safe)."""
    if S.ndim == 0:
        return torch.cosh(S)
    return (torch.linalg.matrix_exp(S) + torch.linalg.matrix_exp(-S)) / 2


def sqrtm(S, iters: int = 40):
    """Principal matrix square root by the Denman–Beavers iteration.

    Valid for defective matrices with no eigenvalue on the closed negative
    real axis — the case of the gun-style ``sqrt`` terms."""
    if S.ndim == 0:
        return torch.sqrt(S)
    dt = torch.promote_types(S.dtype, torch.float32)
    Y = S.to(dt)
    Z = torch.eye(S.shape[-1], dtype=dt, device=S.device)
    for _ in range(iters):
        Yi = torch.linalg.inv(Y)
        Zi = torch.linalg.inv(Z)
        Y, Z = 0.5 * (Y + Zi), 0.5 * (Z + Yi)
    return Y


def _as_complex128(x):
    """Python/numpy scalars and arrays -> complex128 CPU tensors; tensors keep
    their dtype (promoted to complex)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.promote_types(x.dtype, torch.complex64))
    return torch.as_tensor(np.asarray(x, dtype=np.complex128))


def ramp(k, dtype):
    """``[1, 2, ..., k-1]`` in ``dtype`` (complex included)."""
    return torch.arange(1, k, dtype=torch.float64).to(dtype)


def jordan_matrix(lam, k, dtype=torch.complex128):
    """k x k Jordan-chain matrix: ``lam`` on the diagonal, ``1..k-1`` on the
    subdiagonal, so that ``f(J) e_1 = [f, f', ..., f^{(k-1)}](lam)``."""
    J = complex(lam) * torch.eye(k, dtype=dtype)
    if k > 1:
        J = J + torch.diag(ramp(k, dtype), -1)
    return J


def deriv_weights(f, lam, a, startder: int = 0):
    """Weights ``w_j = a_j * f^{(j+startder)}(lam)`` for j = 0..len(a)-1.

    The scaled bidiagonal trick; zeros in ``a`` are handled by substituting
    ratio 1 and masking the output, so a one-hot ``a`` recovers a single
    derivative."""
    lam = _as_complex128(lam)
    a = _as_complex128(a)
    dt = torch.promote_types(lam.dtype, a.dtype)
    a = a.to(dt)
    k = a.shape[0]
    nonzero = a != 0
    a_eff = torch.where(nonzero, a, torch.ones_like(a))
    m = k + startder
    a_ext = torch.cat([torch.ones(startder, dtype=dt), a_eff])
    S = lam.to(dt) * torch.eye(m, dtype=dt)
    if m > 1:
        sub = ramp(m, dt) * a_ext[1:] / a_ext[:-1]
        S = S + torch.diag(sub, -1)
    F = f(S)
    col = F[:, 0] * a_ext[0]
    w = col[startder:]
    return torch.where(nonzero, w, torch.zeros_like(w))


def fun_derivatives(f, lam, k, startder: int = 0):
    """``[f^{(startder)}, ..., f^{(startder+k-1)}](lam)``, complex128 CPU."""
    return deriv_weights(f, lam, torch.ones(k, dtype=torch.float64),
                         startder=startder)


def deriv_table(fv, lam, a, startder: int = 0):
    """Stacked weights ``D[i, j] = a_j * f_i^{(j+startder)}(lam)``."""
    return torch.stack([deriv_weights(f, lam, a, startder=startder)
                        for f in fv])
