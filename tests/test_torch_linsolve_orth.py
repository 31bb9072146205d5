"""Port parity: the linear-solver layer, the orthogonalization kernels, the
small dense eigen/Schur solves and ``expm``, against the JAX package on the
CPU in float64/complex128 (the same inputs, made with numpy from a seed)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import gallery_pair, rel_err

from neptpu.ops import lapack as jlapack
from neptpu.ops import linsolve as jls
from neptpu.ops import matfun as jmatfun
from neptpu.ops import orth as jorth
import neptpu_torch
from neptpu_torch.ops import lapack, linsolve, matfun, orth

LAM = -0.3 + 0.2j


@pytest.fixture(scope="module")
def dep():
    return gallery_pair("dep0_tridiag", 64)


def _rhs(seed=0, k=None):
    rng = np.random.default_rng(seed)
    shape = (64,) if k is None else (64, k)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# one dense LU / solve of the same complex128 matrix on both sides
@pytest.mark.parametrize("name", ["FactorizeLinSolver", "BackslashLinSolver",
                                  "SparseFactorizeLinSolver"])
@pytest.mark.parametrize("k", [None, 3])
def test_direct_linsolvers_match_jax(dep, name, k):
    tnep, jnep = dep
    b = _rhs(1, k)
    x = getattr(linsolve, name)(tnep, LAM).solve(torch.from_numpy(b))
    xj = np.asarray(getattr(jls, name)(jnep, LAM).solve(
        b if name.startswith("Sparse") else jnp.asarray(b)))
    assert rel_err(np.asarray(x), xj) < 1e-12
    # and it solves the system
    M = tnep.Mder_dense(LAM).numpy()
    assert rel_err(M @ np.asarray(x), b) < 1e-12


def test_real_factorization_takes_a_complex_rhs(dep):
    tnep, jnep = dep
    b = _rhs(2)
    x = linsolve.FactorizeLinSolver(tnep, -0.3).solve(torch.from_numpy(b))
    xj = np.asarray(jls.FactorizeLinSolver(jnep, -0.3).solve(jnp.asarray(b)))
    assert x.dtype == torch.complex128 and rel_err(x.numpy(), xj) < 1e-12
    xr = linsolve.lin_solve(linsolve.FactorizeLinSolver(tnep, -0.3),
                            torch.from_numpy(b.real))
    assert xr.dtype == torch.float64
    np.testing.assert_allclose(xr.numpy(), x.real.numpy(), rtol=1e-12)


# matrix-free: both stop at ||r|| <= tol ||b||, along different Krylov
# recurrences, so they meet at the solution to about tol * cond
def test_gmres_linsolver_matches_jax(dep):
    tnep, jnep = dep
    b = _rhs(3)
    kw = dict(tol=1e-13, restart=64, maxiter=20)
    x = linsolve.GMRESLinSolver(tnep, LAM, **kw).solve(torch.from_numpy(b))
    xj = np.asarray(jls.GMRESLinSolver(jnep, LAM, **kw).solve(jnp.asarray(b)))
    assert rel_err(x.numpy(), xj) < 1e-9
    M = tnep.Mder_dense(LAM).numpy()
    assert rel_err(M @ x.numpy(), b) < 1e-12
    X = neptpu_torch.create_linsolver(
        linsolve.GMRESLinSolverCreator(**kw), tnep, LAM).solve(
            torch.from_numpy(np.stack([b, 2 * b], axis=1)))
    assert rel_err(X[:, 0].numpy(), x.numpy()) < 1e-12
    # a preconditioned run on a plain matrix
    A = np.diag(np.arange(1.0, 41.0)) + 0.01 * np.random.default_rng(
        4).standard_normal((40, 40))
    At, bt = torch.from_numpy(A), torch.ones(40, dtype=torch.float64)
    d = torch.from_numpy(1.0 / np.diag(A))
    y = linsolve.gmres(lambda v: At @ v, bt, tol=1e-12, restart=40,
                       M=lambda v: d * v)
    assert rel_err((At @ y).numpy(), bt.numpy()) < 1e-10


# ROADMAP C3: with a preconditioner M = c I the restarts stop at
# ||M r|| <= tol ||b|| (and a restart at tol ||M b||), as
# jax.scipy.sparse.linalg.gmres(solve_method="incremental") does - the
# iterate, and so its true residual, is the JAX package's
@pytest.mark.parametrize("c", [1.0, 1e3, 1e-3])
def test_preconditioned_gmres_stops_where_jax_does(c):
    import jax

    rng = np.random.default_rng(0)
    n = 200
    A = np.diag(np.linspace(1.0, 10.0, n)) + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    kw = dict(tol=1e-6, restart=3, maxiter=200)
    xj, _ = jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=lambda v: c * v,
        solve_method="incremental", **kw)
    xj = np.asarray(xj)
    At = torch.from_numpy(A)
    x = linsolve.gmres(lambda v: At @ v, torch.from_numpy(b),
                       M=lambda v: c * v, **kw).numpy()
    assert rel_err(x, xj) < 1e-8
    relres, relres_j = (np.linalg.norm(A @ y - b) / np.linalg.norm(b)
                        for y in (x, xj))
    assert relres == pytest.approx(relres_j, rel=1e-6)
    if c == 1e-3:  # JAX's rule: the true residual ends far above tol
        assert relres > 1e-4


def test_creators_cache_and_dispatch(dep):
    tnep, _ = dep
    cr = linsolve.FactorizeLinSolverCreator(max_factorizations=1)
    a = cr.create(tnep, LAM)
    assert cr.create(tnep, LAM) is a and cr.create(tnep, 0.1) is not a
    assert len(cr.cache) == 1
    pre = linsolve.FactorizeLinSolverCreator(nep=tnep, precomp_values=[0.1])
    assert pre.create(tnep, 0.1) is pre.cache[complex(0.1)]
    assert pre.create(tnep, 0.2) is not pre.create(tnep, 0.2)
    with pytest.raises(ValueError, match="requires nep"):
        linsolve.FactorizeLinSolverCreator(precomp_values=[0.1])
    sc = linsolve.SparseFactorizeLinSolverCreator(max_factorizations=-1)
    assert sc.create(tnep, LAM) is sc.create(tnep, LAM)
    assert isinstance(neptpu_torch.create_linsolver(None, tnep, LAM),
                      linsolve.FactorizeLinSolver)
    assert isinstance(
        neptpu_torch.create_linsolver(linsolve.BackslashLinSolverCreator,
                                      tnep, LAM), linsolve.BackslashLinSolver)
    assert linsolve.DefaultLinSolverCreator is (
        linsolve.FactorizeLinSolverCreator)


def test_batched_lu_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 20, 20)) + 1j * rng.standard_normal(
        (3, 20, 20))
    b = rng.standard_normal((3, 20)) + 0j
    x = linsolve.batched_lu_solve(
        linsolve.batched_lu_factor(torch.from_numpy(A)), torch.from_numpy(b))
    xj = np.asarray(jls.batched_lu_solve(
        jls.batched_lu_factor(jnp.asarray(A)), jnp.asarray(b)))
    assert rel_err(x.numpy(), xj) < 1e-12
    B = rng.standard_normal((3, 20, 2)) + 0j
    X = linsolve.batched_lu_solve(
        linsolve.batched_lu_factor(torch.from_numpy(A)), torch.from_numpy(B))
    np.testing.assert_allclose(np.einsum("sij,sjk->sik", A, X.numpy()), B,
                               atol=1e-11)


def _basis(k=6, n=50, seed=6):
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, k))
                        + 1j * rng.standard_normal((n, k)))
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return V, w


# the same Gram-Schmidt sweeps in complex128
@pytest.mark.parametrize("name", ["DGKS", "ClassicalGS", "ModifiedGS"])
def test_orth_methods_match_jax(name):
    V, w = _basis()
    for wv in (w, V[:, 0] + 1e-9 * w):  # the second forces DGKS to repeat
        u, h, beta = orth.orthogonalize_and_normalize(
            torch.from_numpy(V), torch.from_numpy(wv), getattr(orth, name)())
        uj, hj, bj = jorth.orthogonalize_and_normalize(
            jnp.asarray(V), jnp.asarray(wv), getattr(jorth, name)())
        assert rel_err(h.numpy(), np.asarray(hj)) < 1e-12
        # beta is what cancellation leaves: absolute error eps * ||w||
        assert abs(float(beta) - float(bj)) < 1e-12 * np.linalg.norm(wv)
        if name == "DGKS":
            assert rel_err(u.numpy(), np.asarray(uj)) < 1e-6
            assert np.abs(V.conj().T @ u.numpy()).max() < 1e-12


def test_orth_takes_a_class_where_jax_calls_it():
    """ROADMAP C2: the JAX package treats a *class* passed as ``orthmethod``
    as a user callable and calls it with (V, w) — a TypeError; the port
    instantiates it."""
    V, w = _basis()
    u, h, beta = orth.orthogonalize_and_normalize(
        torch.from_numpy(V), torch.from_numpy(w), orth.ModifiedGS)
    u2, h2, _ = orth.orthogonalize_and_normalize(
        torch.from_numpy(V), torch.from_numpy(w), orth.ModifiedGS())
    assert torch.equal(u, u2) and torch.equal(h, h2)
    with pytest.raises(TypeError):
        jorth.orthogonalize_and_normalize(jnp.asarray(V), jnp.asarray(w),
                                          jorth.ModifiedGS)


def test_orth_edge_cases():
    V, w = _basis()
    u, h, beta = orth.orthogonalize_and_normalize(
        torch.from_numpy(V[:, :0]), torch.from_numpy(w))
    assert h.shape == (0,) and abs(float(beta) - np.linalg.norm(w)) < 1e-12
    with pytest.raises(TypeError, match="orthmethod"):
        orth.orthogonalize_and_normalize(torch.from_numpy(V),
                                         torch.from_numpy(w), "dgks")
    with pytest.raises(neptpu_torch.LostOrthogonalityException):
        orth.orthogonalize_and_normalize(
            torch.eye(3, dtype=torch.float64)[:, :2],
            torch.tensor([1.0, 2.0, 0.0], dtype=torch.float64),
            orth.ClassicalGS())
    out = orth.orthogonalize_and_normalize(
        torch.from_numpy(V), torch.from_numpy(w), lambda V, w: ("mine",))
    assert out == ("mine",)


def _spectrum_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return max(np.min(np.abs(b - x)) for x in a)


# LAPACK on both sides; eigenvalues as sets, factorizations by what they
# reconstruct (Schur forms are unique only up to ordering and phases)
def test_lapack_matches_jax():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    B = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    w, V = lapack.eig(At)
    assert _spectrum_gap(w.numpy(), np.asarray(jlapack.eig(A)[0])) < 1e-12
    assert rel_err(A @ V.numpy(), V.numpy() * w.numpy()[None, :]) < 1e-12
    assert _spectrum_gap(lapack.eigvals(At).numpy(),
                         np.asarray(jlapack.eigvals(A))) < 1e-12
    w, V = lapack.geig(At, Bt)
    assert _spectrum_gap(w.numpy(), np.asarray(jlapack.geig(A, B)[0])) < 1e-10
    assert rel_err(A @ V.numpy(), B @ V.numpy() * w.numpy()[None, :]) < 1e-10
    T, Z = lapack.schur(At)
    Tj, Zj = jlapack.schur(A)
    assert rel_err(T.numpy(), np.asarray(Tj)) < 1e-12
    assert rel_err(Z.numpy() @ T.numpy() @ Z.numpy().conj().T, A) < 1e-12
    T, Z, cnt = lapack.ordschur_inside(At, 0.0, 2.0)
    Tj, Zj, cj = jlapack.ordschur_inside(A, 0.0, 2.0)
    assert cnt == int(np.real(np.asarray(cj))) > 0
    assert np.all(np.abs(np.diag(T.numpy())[:cnt]) < 2.0)
    assert rel_err(T.numpy(), np.asarray(Tj)) < 1e-12
    AA, BB, Q, Zq = (x.numpy() for x in lapack.qz(At, Bt))
    AAj = np.asarray(jlapack.qz(A, B)[0])
    assert rel_err(AA, AAj) < 1e-12
    assert rel_err(Q @ AA @ Zq.conj().T, A) < 1e-12
    assert rel_err(Q @ BB @ Zq.conj().T, B) < 1e-12
    assert lapack.eigvals(rng.standard_normal((4, 4))).dtype == (
        torch.complex128)


def _companion_pencil(coeffs):
    """Linearization ``(A, B)`` of ``sum_i lam^i coeffs[i]``: ``B`` carries
    the leading coefficient, so a rank-deficient one makes ``B`` singular."""
    d, k = len(coeffs) - 1, coeffs[0].shape[0]
    A = np.zeros((d * k, d * k), dtype=complex)
    B = np.eye(d * k, dtype=complex)
    A[:-k, k:] = np.eye((d - 1) * k)
    A[-k:] = np.hstack([-c for c in coeffs[:-1]])
    B[-k:, -k:] = coeffs[-1]
    return A, B


# scipy.linalg.eig (QZ) on both sides: finite eigenvalues as sets to rel
# 1e-10, the same number of infinite ones
@pytest.mark.parametrize("lead_rank", [4, 2, 0])
def test_geig_matches_jax_on_singular_and_invertible_pencils(lead_rank):
    rng = np.random.default_rng(17)
    k = 4
    coeffs = [rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
              for _ in range(3)]
    coeffs[2] = (coeffs[2][:, :lead_rank]
                 @ rng.standard_normal((lead_rank, k)))
    A, B = _companion_pencil(coeffs)
    w, V = lapack.geig(torch.from_numpy(A), torch.from_numpy(B))
    assert w.dtype == V.dtype == torch.complex128 and V.shape == A.shape
    w, V = w.numpy(), V.numpy()
    wj = np.asarray(jlapack.geig(A, B)[0])
    fin, finj = np.isfinite(w), np.isfinite(wj)
    assert fin.sum() == finj.sum() == k * (2 - 1) + lead_rank
    assert (~fin).sum() == (~finj).sum() == k - lead_rank
    for x in w[fin]:
        assert np.min(np.abs(wj[finj] - x)) <= 1e-10 * abs(x)
    # the finite pairs solve the pencil
    Vf = V[:, fin]
    assert rel_err(A @ Vf, B @ Vf * w[fin][None, :]) < 1e-10


# Pade scaling-and-squaring on both sides; a Jordan block is the case the
# derivative tables feed it
def test_expm_matches_jax():
    rng = np.random.default_rng(8)
    S = rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
    J = matfun.jordan_matrix(-0.4 + 0.3j, 6)
    for X in (S, J.numpy(), -2.0 * J.numpy()):
        E = matfun.expm(torch.from_numpy(X)).numpy()
        assert rel_err(E, np.asarray(jmatfun.expm(jnp.asarray(X)))) < 1e-12
    z = torch.tensor(0.3 - 0.2j, dtype=torch.complex128)
    assert abs(complex(matfun.expm(z)) - np.exp(0.3 - 0.2j)) < 1e-15
    d = matfun.fun_derivatives(lambda X: matfun.expm(-2.0 * X), 0.1, 5)
    np.testing.assert_allclose(
        d.numpy(), [(-2.0) ** j * np.exp(-0.2) for j in range(5)],
        rtol=1e-12)
