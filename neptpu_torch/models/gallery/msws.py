"""Middle Square Weyl Sequence RNG (B. Widynski, arXiv 1704.00358).

Reimplements the exact generator the reference gallery uses for reproducible
random matrices (reference ``src/gallery_extra/basic_random_examples.jl:71-128``)
so that gallery problems are bit-identical to the reference's across releases
and languages.  Pure Python 128-bit integer arithmetic.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MSWS_RNG"]

_M128 = (1 << 128) - 1
_M64 = (1 << 64) - 1


class MSWS_RNG:
    def __init__(self, seed: int = 0):
        base = 0x9EF09A97AC0F9ECAEF01C4F2DB0958C9
        self.s = ((seed << 1) + base) & _M128
        self.x = 0x1DE568E1A1CA1B593CBF13F7407CF43E
        self.w = 0xD4AC5C288559E14A5FAFC1B7DF9F9E0E

    def gen_int(self) -> int:
        self.x = (self.x * self.x) & _M128
        self.w = (self.w + self.s) & _M128
        self.x = (self.x + self.w) & _M128
        self.x = ((self.x >> 64) | (self.x << 64)) & _M128
        return self.x & _M64

    def gen_float(self) -> float:
        return self.gen_int() / _M64

    def gen_mat(self, n: int, m: int) -> np.ndarray:
        """Column-major fill of 1 - 2*u, matching the reference loop order."""
        vals = np.array(
            [1.0 - 2.0 * self.gen_float() for _ in range(n * m)], dtype=np.float64
        )
        return vals.reshape(m, n).T

    def gen_spmat(self, n: int, m: int, p: float):
        """Sparse random matrix: round(p*m*n) draws into a dict (later draws
        overwrite earlier at the same position), then CSR."""
        import scipy.sparse as sp

        nonzeros = round(p * m * n)
        d = {}
        for _ in range(int(nonzeros)):
            r = self.gen_int() % n
            c = self.gen_int() % m
            d[(r, c)] = 1.0 - 2.0 * self.gen_float()
        if not d:
            return sp.csr_matrix((n, m))
        rows, cols, vals = zip(*[(r, c, v) for (r, c), v in d.items()])
        return sp.csr_matrix(
            sp.coo_matrix((vals, (rows, cols)), shape=(n, m))
        )
