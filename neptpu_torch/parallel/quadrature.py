"""Quadrature-node parallelism over the ranks of a mesh.

The contour nodes are split over the ``nodes`` axis: every rank runs the
batched assemble + LU + solve pipeline of ``solvers/contour.py``
(``batched_shifted_solves``: one LU per matrix, cuSOLVER on the card) on its
own nodes, weights them with ``contour_moment_weights``, and the moments are
reduced with one ``psum``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sharded_contour_moments"]


def sharded_contour_moments(nep, sigma, radius, Vh, N, n_moments, mesh,
                            axis: str = "nodes", chunk: int = 32):
    """Moments ``A_j = 1/(2 pi i) int T(g(t)) g'(t) g(t)^j dt`` with the node
    axis split over ``mesh``'s ``axis``.

    Needs a NEP with a dense ``Mder`` (SPMF form).  ``N`` is rounded up to a
    multiple of the axis size so every rank takes as many nodes.  Returns a
    ``(n_moments, n, k)`` complex128 tensor on ``mesh.device``, the same on
    every rank."""
    from ..solvers.contour import (batched_shifted_solves,
                                   contour_moment_weights)

    ndev = mesh.size(axis)
    N = int(np.ceil(N / ndev) * ndev)
    radius = (radius, radius) if np.isscalar(radius) else tuple(radius)
    gs, wts = contour_moment_weights(radius, N, n_moments)
    per = N // ndev
    r = mesh.rank(axis)
    mine = slice(r * per, (r + 1) * per)
    Vh = torch.as_tensor(Vh, device=mesh.device).to(torch.complex128)
    Y = batched_shifted_solves(nep, complex(sigma) + gs[mine], Vh, chunk)
    part = torch.einsum("mN,Nnk->mnk",
                        torch.as_tensor(wts[:, mine], device=Y.device), Y)
    return mesh.psum(part, axis)
