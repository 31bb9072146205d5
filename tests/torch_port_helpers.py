"""Shared fixtures of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference (``neptpu``, on the CPU in float64) and the port
(``neptpu_torch``, on a torch CPU device) compute from identical operands.
"""
import os

import numpy as np
import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS before the cap)
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# the port's entry points default to the card (``neptpu_torch.config``); the
# parity tests run on the CPU and say so at every call
CPU = "cpu"

# The thread policy of the whole test run: one BLAS, OpenMP and torch
# intra-op thread in every process.  Tier-1 runs six pytest workers on one
# host, and each worker imports this module while it collects, before any
# test runs, so the policy covers every test of the run, the JAX package's
# too.  numpy's and scipy's OpenBLAS otherwise start a pool of one thread a
# core in each worker, and their threads spin while they wait: six workers
# on an 8-core CPU host then ran the slowest tests tens of times slower than
# alone (the fiber quasinewton test: 1017 s in the run, 24 s alone; the
# whole run 1250 s against 391 s under this policy).  Children
# (spawned gloo ranks, subprocess probes) read the environment when their
# BLAS loads; the pools already loaded here are capped through threadpoolctl
# where it is installed.  Torch keeps one intra-op thread: with two,
# ``torch.linalg.inv`` of a float32 batch hangs inside oneMKL on this build.
for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the card's machine may lack it: the env alone applies
    pass
else:
    threadpool_limits(1, user_api="blas")
torch.set_num_threads(1)

# the small gun-structured fixture's shift and scale (its spectrum spans
# about [0, 8 (nx+1)^2]; the gun_like bench point sits at a quarter of it)
SMALL_SIGMA = 1250.0 + 5.0j
SMALL_GAMMA = 600.0


def small_gun_like(nx=24, seed=0):
    """Scipy operands ``(K, M, W1, W2)`` with the gun_like structure at
    n = nx^2: the 2D 5-point Laplacian scaled by (nx+1)^2, the diagonal mass
    matrix 1 + 0.1 cos(r), and an 8x8 boundary box W1 (rows/cols drawn with
    ``seed``) with W2 = W1^T.  It takes the same DIA bank + low-rank path as
    full gun_like."""
    n = nx * nx
    rng = np.random.default_rng(seed)
    L1 = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                  [-1, 0, 1])
    L2d = sp.kron(L1, sp.eye(nx)) + sp.kron(sp.eye(nx), L1)
    K = (L2d.tocsr() * (nx + 1) ** 2).tocsr()
    M = sp.diags(np.full(n, 1.0) + 0.1 * np.cos(np.arange(n))).tocsr()
    idx = rng.choice(n, size=8, replace=False)
    vals = rng.standard_normal((8, 8))
    W1 = sp.csr_matrix((vals.ravel(), (np.repeat(idx, 8), np.tile(idx, 8))),
                       shape=(n, n))
    W2 = W1.T.tocsr()
    return K, M, W1, W2



def small_gun_ops(n=60, seed=0):
    """The operands of ``tests/test_spmf_real.py``'s ``_small_gun``: a PEP
    (K, -M) plus W1, W2 = W1^T on i sqrt(lam) and i sqrt(lam - 9)."""
    rng = np.random.default_rng(seed)
    K = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.4),
                  np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr() * (n + 1)
    M = sp.diags(np.full(n, 1.0) + 0.1 * np.cos(np.arange(n))).tocsr()
    idx = rng.choice(n, size=6, replace=False)
    vals = rng.standard_normal((6, 6)) * 0.3
    W1 = sp.csr_matrix((vals.ravel(), (np.repeat(idx, 6), np.tile(idx, 6))),
                       shape=(n, n))
    return K, (-M).tocsr(), W1, W1.T.tocsr()

def to_spec(obj):
    """A JAX pytree object (bank or solver) -> the numpy spec triple
    ``(kind, leaves, aux)`` that ``neptpu_torch.interop`` reads."""
    children, aux = obj.tree_flatten()

    def conv(c):
        if c is None:
            return None
        if hasattr(c, "tree_flatten"):
            return to_spec(c)
        if isinstance(c, tuple):
            return tuple(conv(x) for x in c)
        return np.asarray(c)

    return type(obj).__name__, [conv(c) for c in children], aux


def backward_errmeasure(mats, fv, fun_scalars):
    """Backward error ``||M(lam) q|| / sum_i |f_i(lam)| ||A_i||_F`` on the
    host (``fun_scalars`` from either package)."""
    fro = np.array([np.sqrt(np.abs(A.multiply(A.conj())).sum())
                    for A in mats])
    csr = [A.tocsr() for A in mats]

    def err(lam, q):
        w = fun_scalars(fv, lam)
        y = sum(wi * (A @ q) for wi, A in zip(w, csr))
        return float(np.linalg.norm(y) / (np.abs(w) @ fro))

    return err


# shift of the delay-problem parity tests (dep0_tridiag)
DEP_SIGMA = -0.2 + 0.1j


def gallery_pair(name, *args):
    """The same gallery problem from the port (on the CPU) and from the JAX
    package."""
    import neptpu
    import neptpu_torch

    return (neptpu_torch.nep_gallery(name, *args, device=CPU),
            neptpu.nep_gallery(name, *args))


def conj_set_gap(a, b):
    """Largest relative distance from a value of ``a`` to the nearest of
    ``b`` or its conjugates (a real problem's spectrum is closed under
    conjugation, and a solver may return either member of a pair)."""
    a, b = np.asarray(a), np.asarray(b)
    return max(min(np.min(np.abs(b - x)), np.min(np.abs(b - np.conj(x))))
               / abs(x) for x in a)


class BankSpy:
    """A bank seen by a scan: records the shape, strides and contiguity of
    every operand handed to the term-major split apply, then applies the
    real bank."""

    def __init__(self, bank):
        self.bank = bank
        self.seen = []

    def __getattr__(self, name):
        return getattr(self.bank, name)

    def lincomb_apply_split_t(self, WreT, WimT):
        for W in (WreT, WimT):
            self.seen.append((tuple(W.shape), W.is_contiguous()))
        return self.bank.lincomb_apply_split_t(WreT, WimT)

    def lincomb_apply_split(self, Wre, Wim):
        raise AssertionError("the scan handed the bank a row-major operand")

    lincomb_apply = lincomb_apply_pair = lincomb_apply_split


def rel_err(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class NoHostFunctions(TorchFunctionMode):
    """Fails on every Python-level read of a tensor to the host and every
    tensor made from host data."""

    BANNED = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__index__", "__float__", "__complex__", "as_tensor", "tensor",
              "from_numpy"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.BANNED:
            raise AssertionError(f"the scan step called {name}")
        return func(*args, **(kwargs or {}))


class NoScalarReads(TorchDispatchMode):
    """Fails where ATen reads a tensor's value as a number (a tensor used
    as a Python index or size goes through here)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the scan step read a tensor as a number")
        return func(*args, **(kwargs or {}))
