"""Backward error of an eigenpair of a sum of products of matrices and
functions, M(lam) = sum_i f_i(lam) A_i, in plain NumPy/SciPy float64.

    eta(lam, q) = ||M(lam) q|| / (||q|| sum_i |f_i(lam)| ||A_i||_F)

is NEP-PACK's default measure for such problems (``src/errmeasure.jl``,
``StandardSPMFErrmeasure``).  All terms are stacked into one tall CSR so a
batch of k pairs costs one sparse product and one contraction.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class SPMFReference:
    """``mats``: the n x n term matrices (scipy sparse); ``weights(lams)``:
    the (terms, k) complex128 values f_i(lams[j])."""

    def __init__(self, mats, weights):
        self.mats = [sp.csr_matrix(A, dtype=np.result_type(A.dtype, float))
                     for A in mats]
        self.n = self.mats[0].shape[0]
        self.weights = weights
        self._stack = sp.vstack(self.mats, format="csr")
        self.fro = np.array([np.sqrt(np.sum(np.abs(A.data) ** 2))
                             for A in self.mats])

    def backward(self, lams, Q):
        """Backward errors of the pairs ``(lams[j], Q[:, j])``, float64."""
        lams = np.atleast_1d(np.asarray(lams, dtype=complex))
        Q = np.asarray(Q, dtype=complex).reshape(self.n, len(lams))
        if not len(lams):
            return np.zeros(0)
        W = self.weights(lams)
        T = np.asarray(self._stack @ Q).reshape(len(self.mats), self.n, -1)
        r = np.linalg.norm(np.einsum("tnk,tk->nk", T, W), axis=0)
        scale = np.linalg.norm(Q, axis=0) * (np.abs(W).T @ self.fro)
        return r / scale
