"""Port parity: the Krylov variants ``iar_chebyshev`` (every ``compute_y0``
mode, the explicit shift of a delay problem, a callable ``compute_y0``),
``infbilanczos`` and ``ilan``, against the JAX package on the CPU in
complex128.

Tolerances: eigenvalues as conjugation-aware sets to rel 1e-10 (the two
packages run the same recurrences in another summation order); ``ilan``'s
pieces to 1e-12; a whole ``ilan`` run against the JAX package's ``iar``
eigenvalues (its own ``ilan`` takes half a minute at n = 64)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, conj_set_gap, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.solvers import iar_chebyshev as _exported_cheb
from neptpu_torch.solvers.iar_chebyshev import _cheb_vals
from neptpu_torch.solvers.ilan import (_bmult, _fdh_tables,
                                       symmetrizer_coefficients, term_matmat)

jilan = importlib.import_module("neptpu.solvers.ilan")

DEP0_LAM = -0.15955391823299267  # the JAX package's test oracle


@pytest.fixture(scope="module")
def dep0():
    return gallery_pair("dep0")


def _resnorm(tnep, lam, q):
    return float(neptpu_torch.compute_resnorm(tnep, complex(lam), q))


@pytest.mark.parametrize("method", [":DEP", ":SPMF", ":Generic"])
def test_iar_chebyshev_modes_match_jax(dep0, method):
    tnep, jnep = dep0
    kw = dict(neigs=3, maxit=30, v=np.ones(5), tol=1e-10,
              compute_y0_method=method)
    lam, Q = neptpu_torch.iar_chebyshev(tnep, device=CPU, **kw)
    lj, _ = neptpu.iar_chebyshev(jnep, **kw)
    assert len(lam) == len(np.asarray(lj)) == 3
    assert conj_set_gap(lam, np.asarray(lj)) < 1e-10
    assert np.min(np.abs(lam - DEP0_LAM)) < 1e-8
    for i in range(len(lam)):
        assert _resnorm(tnep, lam[i], Q[:, i]) < 1e-9


def test_iar_chebyshev_pep_mode_matches_jax():
    tnep, jnep = gallery_pair("pep0", 10)
    kw = dict(neigs=2, maxit=30, v=np.ones(10), tol=1e-8)
    lam, Q = neptpu_torch.iar_chebyshev(tnep, device=CPU, **kw)
    lj, _ = neptpu.iar_chebyshev(jnep, **kw)
    assert len(lam) == 2 and conj_set_gap(lam, np.asarray(lj)) < 1e-10
    for i in range(len(lam)):
        assert _resnorm(tnep, lam[i], Q[:, i]) < 1e-6


def test_iar_chebyshev_shifted_dep(dep0):
    """sigma != 0 on a DEP: the problem is shifted and scaled explicitly
    (with the JAX package's warning) and the eigenvalues mapped back.  The
    JAX package's own call raises here (it hands ``shift_and_scale`` a
    complex scale, so the shifted DEP's delays are complex); it is held
    through ``shift_and_scale`` of its own problem at sigma = 0."""
    tnep, jnep = dep0
    sigma, gamma = -0.1, 1.5
    kw = dict(neigs=3, maxit=30, v=np.ones(5), tol=1e-10)
    with pytest.warns(UserWarning, match="explicitly shifted and scaled"):
        lam, Q = neptpu_torch.iar_chebyshev(tnep, sigma=sigma, gamma=gamma,
                                            device=CPU, **kw)
    with pytest.warns(UserWarning), pytest.raises(ValueError,
                                                  match="delays"):
        neptpu.iar_chebyshev(jnep, sigma=sigma, gamma=gamma, **kw)
    from neptpu.transforms import shift_and_scale

    mu, _ = neptpu.iar_chebyshev(
        shift_and_scale(jnep, shift=sigma, scale=gamma), **kw)
    lj = sigma + gamma * np.asarray(mu)
    assert conj_set_gap(lam, lj) < 1e-10
    for i in range(len(lam)):
        assert _resnorm(tnep, lam[i], Q[:, i]) < 1e-8


def _dep_y0(nep, X, Y, k, M0inv, a, b):
    """The ``:DEP`` recurrence written as a user would (either package:
    numpy in, numpy out)."""
    X, Y = np.asarray(X), np.asarray(Y)
    cc, kk = (a + b) / (a - b), 2 / (b - a)
    m = Y.shape[1] + 1
    Tc = _cheb_vals(cc, m)
    y0 = X @ Tc[:k]
    mats = [A.toarray() for A in neptpu_torch.nep_gallery(
        "dep0", device=CPU).bank.host_csr_terms()]
    for A, tau in zip(mats, nep.tauv):
        y0 = y0 - A @ (Y[:, : k + 1] @ _cheb_vals(-kk * tau + cc, m)[: k + 1])
    x = M0inv.solve(torch.from_numpy(y0) if isinstance(
        M0inv, neptpu_torch.LinSolver) else jnp.asarray(y0))
    return np.asarray(x)


def test_iar_chebyshev_callable_y0(dep0):
    """A callable ``compute_y0``: with the JAX package's signature it gets
    no shift (both packages agree, and equal the ``:DEP`` mode); one that
    takes ``sigma`` and ``gamma`` gets them as keywords (ROADMAP C2)."""
    tnep, jnep = dep0
    kw = dict(neigs=3, maxit=30, v=np.ones(5), tol=1e-10)
    lam, _ = neptpu_torch.iar_chebyshev(tnep, compute_y0_method=_dep_y0,
                                        device=CPU, **kw)
    lj, _ = neptpu.iar_chebyshev(jnep, compute_y0_method=_dep_y0, **kw)
    ld, _ = neptpu_torch.iar_chebyshev(tnep, compute_y0_method=":DEP",
                                       device=CPU, **kw)
    assert conj_set_gap(lam, np.asarray(lj)) < 1e-10
    assert conj_set_gap(lam, ld) < 1e-10
    seen = []

    def shifted(nep, X, Y, k, M0inv, a, b, sigma=None, gamma=None):
        seen.append((sigma, gamma))
        return _dep_y0(nep, X, Y, k, M0inv, a, b)

    lam2, _ = neptpu_torch.iar_chebyshev(
        tnep, compute_y0_method=shifted, sigma=0.0, gamma=1.0, device=CPU,
        **kw)
    assert seen and set(seen) == {(0j, 1 + 0j)}
    assert conj_set_gap(lam2, lam) < 1e-12
    with pytest.raises(TypeError):
        neptpu.iar_chebyshev(jnep, compute_y0_method=lambda *a, sigma, gamma:
                             None, **kw)


def test_infbilanczos_matches_jax(dep0):
    tnep, jnep = dep0
    At = [A.toarray().T for A in tnep.bank.host_csr_terms()]
    tnept = neptpu_torch.DEP(At, tnep.tauv, device=CPU)
    jnept = neptpu.DEP(At, np.asarray(jnep.tauv))
    kw = dict(v=np.ones(5), u=np.ones(5), neigs=2, maxit=30, tol=1e-8)
    lam, Q, T = neptpu_torch.infbilanczos(tnep, tnept, device=CPU, **kw)
    lj, Qj, Tj = neptpu.infbilanczos(jnep, jnept, **kw)
    assert len(lam) == len(np.asarray(lj)) >= 2
    assert conj_set_gap(lam, np.asarray(lj)) < 1e-10
    # the same tridiagonal; its trailing ghost pairs are ill-conditioned,
    # so the leading block is compared
    assert T.shape == np.asarray(Tj).shape
    assert rel_err(T[:3, :3], np.asarray(Tj)[:3, :3]) < 1e-10
    for i in range(len(lam)):
        assert _resnorm(tnep, lam[i], Q[:, i]) < 1e-7


def test_ilan_pieces_match_jax():
    """``symmetrizer_coefficients`` and ``_fdh_tables`` equal the JAX
    functions; one ``Bmult`` (the rank-q delay fast path, through the DIA
    bank's fused apply on one term at a time) equals the generic
    ``sum_t Av[t] Qn (G .* FDH[t])`` built from the JAX package's tables and
    dense operands."""
    tnep0, jnep = gallery_pair("dep_symm_double", 8)
    # the DIA bank the card's problem has (n = 64 alone would pick CSR)
    bank = DiaTermBank.from_matrices(tnep0.bank.host_csr_terms(), device=CPU)
    tnep = neptpu_torch.DEP(None, tauv=tnep0.tauv, bank=bank)
    m, sigma, gamma, k = 12, -1.0 + 0.1j, 1.3, 9
    G = symmetrizer_coefficients(m)
    np.testing.assert_array_equal(G, jilan.symmetrizer_coefficients(m))
    F = _fdh_tables(tnep, m, sigma, gamma)
    Fj = jilan._fdh_tables(jnep, m, sigma, gamma)
    for a, b in zip(F, Fj):  # (the delay-free term's table is zero)
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)
    rng = np.random.default_rng(2)
    Qn = rng.standard_normal((tnep.n, m + 1)) + 1j * rng.standard_normal(
        (tnep.n, m + 1))
    Z = _bmult(tnep, k, torch.from_numpy(Qn), G, F, sigma, gamma).numpy()
    Av = [np.eye(tnep.n)] + [A.toarray() for A in
                             jnep.bank.host_csr_terms()]
    # the JAX package's fast path (its closure ``Bmult``, ilan.py:107-126)
    # on the dense operands: rank-q exact to the SVD cut
    U, S, Vt = np.linalg.svd(G[: k + 1, : k + 1])
    q = int(np.sum(S > 1e-12))
    Us, Vs = U[:, :q] * np.sqrt(S[:q]), Vt[:q].T * np.sqrt(S[:q])
    Zq = np.zeros((tnep.n, k + 1), dtype=complex)
    Zq[:, 0] = -gamma * Qn[:, 0]
    for t, tau in enumerate(np.asarray(jnep.tauv, dtype=float)):
        w = (gamma * (-tau)) ** np.arange(k + 1)
        c = gamma * (-tau) * np.exp(-sigma * tau)
        Zq += c * (Av[t + 1] @ (Qn[:, : k + 1] @ (Us * w[:, None]))
                   @ (Vs * w[:, None]).T)
    assert q < k + 1 and rel_err(Z, Zq) < 1e-12
    # and the generic sum_t Av[t] Qn (G .* FDH[t]) from the JAX tables
    Zref = sum(A @ (Qn[:, : k + 1] @ (G[: k + 1, : k + 1]
                                      * f[: k + 1, : k + 1]))
               for A, f in zip(Av, Fj))
    assert rel_err(Z, Zref) < 1e-9
    # a single term through the bank equals the term's own matrix
    X = torch.from_numpy(Qn[:, :3].copy())
    assert rel_err(term_matmat(tnep, 2, X).numpy(), Av[2] @ Qn[:, :3]) < 1e-14


@pytest.mark.parametrize("proj_solve", [True, False])
def test_ilan_run_matches_jax_iar(proj_solve):
    """The whole ``ilan`` run on ``dep_symm_double`` (n = 64; the JAX
    package's test arguments) against the JAX package's ``iar``."""
    tnep, jnep = gallery_pair("dep_symm_double", 8)
    lam, W, err, V = neptpu_torch.ilan(
        tnep, sigma=0.0, neigs=3, maxit=30, v=np.ones(tnep.n), tol=1e-8,
        check_error_every=10, proj_solve=proj_solve, device=CPU)
    lj, _, _ = neptpu.iar(jnep, sigma=0.0, neigs=6, maxit=40,
                          v=np.ones(jnep.n), tol=1e-10)
    assert len(lam) >= 3 and W.shape == (tnep.n, len(lam))
    assert conj_set_gap(lam, np.asarray(lj)) < 1e-10
    em = neptpu_torch.StandardSPMFErrmeasure(tnep)
    for i in range(len(lam)):
        assert float(em(complex(lam[i]), W[:, i])) < 1e-8


def test_krylov_variants_are_exported():
    assert _exported_cheb is neptpu_torch.iar_chebyshev
    for name in ("iar_chebyshev", "ilan", "infbilanczos", "blocknewton",
                 "broyden", "iar_real_spmf_deflated"):
        assert getattr(neptpu_torch.solvers, name) is getattr(neptpu_torch,
                                                              name)
