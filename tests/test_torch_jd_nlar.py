"""Port parity: the projection solvers - Jacobi-Davidson (``jd_betcke``,
``jd_effenberger``), nonlinear Arnoldi (``nlar``) and ``iar``/``tiar`` with
``proj_solve=True`` - on small problems in complex128 on the CPU.

The JAX package runs these end to end in tens of seconds each (its JD and
NLAR tests are marked slow), so each port run is held against the JAX
package's eigenvalues of the same problem from a faster route (``polyeig``
for a PEP, ``iar`` for a DEP) to rel 1e-8 modulo conjugation, and the
per-iteration pieces (sorters) against the JAX package's directly."""
import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, conj_set_gap, gallery_pair

import neptpu
import neptpu_torch

GAP = 1e-8


def _resnorms(nep, lams, V):
    return [float(neptpu_torch.compute_resnorm(nep, complex(lams[i]), V[:, i])
                  / torch.linalg.vector_norm(V[:, i]))
            for i in range(len(lams))]


def _distinct(lams, rel=1e-8):
    lams = np.asarray(lams)
    return all(abs(a - b) > rel * abs(a)
               for i, a in enumerate(lams) for b in lams[i + 1:])


@pytest.fixture(scope="module")
def pep40():
    tnep, jnep = gallery_pair("pep0", 40)
    return tnep, np.asarray(neptpu.polyeig(jnep)[0])


@pytest.fixture(scope="module")
def dep0():
    tnep, jnep = gallery_pair("dep0")
    lj = np.asarray(neptpu.iar(jnep, sigma=0.0, neigs=6, maxit=40,
                               v=np.ones(5), tol=1e-12)[0])
    return tnep, lj


def test_jd_betcke_on_a_dep(dep0):
    tnep, lj = dep0
    lam, V = neptpu_torch.jd_betcke(tnep, neigs=1, maxit=tnep.n,
                                    v=np.ones(tnep.n), tol=1e-10, device=CPU)
    assert isinstance(lam, np.ndarray) and isinstance(V, torch.Tensor)
    assert conj_set_gap(lam, lj) < GAP
    assert max(_resnorms(tnep, lam, V)) < 1e-8


@pytest.mark.parametrize("projtype", [":PetrovGalerkin", ":Galerkin"])
def test_jd_betcke_on_a_pep(pep40, projtype):
    tnep, lj = pep40
    lam, V = neptpu_torch.jd_betcke(tnep, neigs=2, maxit=40, v=np.ones(40),
                                    tol=1e-9, projtype=projtype, device=CPU)
    assert len(lam) == 2 and _distinct(lam)
    assert conj_set_gap(lam, lj) < GAP
    assert max(_resnorms(tnep, lam, V)) < 1e-6


def test_jd_betcke_checks_its_arguments(pep40):
    tnep, _ = pep40
    with pytest.raises(ValueError, match="larger than size"):
        neptpu_torch.jd_betcke(tnep, maxit=41, device=CPU)
    with pytest.raises(ValueError, match="projtype"):
        neptpu_torch.jd_betcke(tnep, maxit=40, projtype=":Ritz", device=CPU)
    with pytest.raises(ValueError, match="SGITER"):
        neptpu_torch.jd_betcke(tnep, maxit=40, inner_solver_method=(
            neptpu_torch.SGIterInnerSolver()), device=CPU)
    with pytest.raises(ValueError, match="min-max"):
        neptpu_torch.jd_effenberger(tnep, maxit=40, inner_solver_method=(
            neptpu_torch.SGIterInnerSolver()), device=CPU)
    with pytest.raises(neptpu_torch.NoConvergenceException) as exc:
        neptpu_torch.jd_betcke(tnep, neigs=2, maxit=2, v=np.ones(40),
                               tol=1e-9, device=CPU)
    assert exc.value.v.shape[0] == 40


def test_jd_effenberger_deflates_without_reconverging():
    """Two levels of deflation on dep0 (n = 30): the pairs of the invariant
    pair, distinct, are eigenpairs of the original problem, the JAX
    package's ``iar`` finds the same eigenvalues."""
    tnep, jnep = gallery_pair("dep0", 30)
    lj = np.asarray(neptpu.iar(jnep, sigma=0.0, neigs=8, maxit=60,
                               v=np.ones(30), tol=1e-12)[0])
    lam, V = neptpu_torch.jd_effenberger(tnep, neigs=2, maxit=30, lam=0.0,
                                         v=np.ones(30), tol=1e-10, device=CPU)
    assert len(lam) == 2 and _distinct(lam)
    assert conj_set_gap(lam, lj) < GAP
    assert max(_resnorms(tnep, lam, V)) < 1e-8


def test_jd_effenberger_on_a_banded_dep_with_a_residual_inner_solver():
    """The settings of the card's run at a small size: dep_symm_double on a
    16 x 16 grid (the DIA bank padded for each level), three pairs near -1,
    an absolute tolerance from the problem's scale and the inner IAR held to
    the same absolute residual with a short Taylor expansion."""
    tnep, jnep = gallery_pair("dep_symm_double", 16)
    lj = np.asarray(neptpu.iar(jnep, sigma=-1.0, neigs=6, maxit=40,
                               v=np.ones(tnep.n), tol=1e-12)[0])
    mats = tnep.bank.host_csr_terms()
    scale = np.sqrt(tnep.n) + sum(
        abs(np.exp(t)) * np.sqrt(A.multiply(A).sum())
        for t, A in zip(tnep.tauv, mats))
    inner = neptpu_torch.IARInnerSolver(maxit=12, iar_function=(
        functools.partial(neptpu_torch.iar,
                          errmeasure=neptpu_torch.ResidualErrmeasure)))
    lam, V = neptpu_torch.jd_effenberger(
        tnep, neigs=3, maxit=40, lam=-1.0, v=np.ones(tnep.n), target=-1.0,
        tol=1e-11 * scale, inner_solver_method=inner, device=CPU)
    assert len(lam) == 3 and _distinct(lam)
    assert conj_set_gap(lam, lj) < GAP
    em = neptpu_torch.StandardSPMFErrmeasure(tnep)
    assert max(em(complex(l), V[:, i]) for i, l in enumerate(lam)) < 1e-10


def test_nlar_on_a_pep(pep40):
    tnep, lj = pep40
    D, X, hist = neptpu_torch.nlar(tnep, neigs=2, maxit=40, lam=0.0,
                                   v=np.ones(40), tol=1e-12,
                                   num_restart_ritz_vecs=2, device=CPU)
    assert isinstance(D, np.ndarray) and X.shape == (40, 2)
    assert hist.shape == (40, 2)
    assert _distinct(D) and conj_set_gap(D, lj) < GAP
    assert max(_resnorms(tnep, D, X)) < 1e-7


@pytest.mark.parametrize("sorter", ["default_eigval_sorter",
                                    "residual_eigval_sorter",
                                    "threshold_eigval_sorter"])
def test_nlar_sorters(sorter):
    """Each sorter drives nlar to two pairs of pep0 (n = 50); the sorter
    itself orders a Ritz set as the JAX package's does."""
    tnep, jnep = gallery_pair("pep0", 50)
    lj = np.asarray(neptpu.polyeig(jnep)[0])
    D, X, _ = neptpu_torch.nlar(tnep, neigs=2, maxit=50, lam=0.0,
                                v=np.ones(50), tol=1e-12,
                                num_restart_ritz_vecs=2,
                                eigval_sorter=getattr(neptpu_torch, sorter),
                                device=CPU)
    assert conj_set_gap(D, lj) < GAP
    assert max(_resnorms(tnep, D, X)) < 1e-7
    # the sorter alone: same order and values on the same Ritz set
    rng = np.random.default_rng(1)
    Vk = np.linalg.qr(rng.standard_normal((50, 4)))[0] + 0j
    dd = np.array([0.1 + 0.2j, -0.3, 0.05, 0.5 - 0.1j])
    vv = rng.standard_normal((4, 4)) + 0j
    out_t = getattr(neptpu_torch, sorter)(tnep, dd, vv, 0.0, np.array([0.11]),
                                          0.2, torch.from_numpy(Vk))
    out_j = getattr(neptpu, sorter)(jnep, dd, vv, 0.0, np.array([0.11]), 0.2,
                                    Vk)
    np.testing.assert_allclose(out_t[0], np.asarray(out_j[0]), rtol=1e-12)
    np.testing.assert_allclose(out_t[1], np.asarray(out_j[1]), rtol=1e-12)


def test_jd_eig_sorter_matches_jax():
    from neptpu.solvers.jd import jd_eig_sorter as jsort

    from neptpu_torch.solvers.jd import jd_eig_sorter as tsort

    lamv = np.array([0.3, -0.1 + 0.2j, 0.05, 1.0])
    V = np.arange(16.0).reshape(4, 4) + 0j
    for N in (1, 2, 7):
        lt, vt = tsort(lamv, V, N, 0.1)
        lj, vj = jsort(lamv, V, N, 0.1)
        assert lt == complex(lj) and np.array_equal(vt, np.asarray(vj))


@pytest.mark.parametrize("name", ["iar", "tiar"])
@pytest.mark.parametrize("inner", [None, "NewtonInnerSolver"])
def test_krylov_proj_solve(dep0, name, inner):
    """``proj_solve=True`` (the Ritz values refined on the projected
    problem by an inner solver) on dep0, against the JAX package's plain
    ``iar`` eigenvalues; the JAX test's settings (``tests/test_krylov.py``)
    with ``check_error_every=5``.  (tiar needs n >= maxit: dep0 on n = 40.)"""
    if name == "tiar":
        tnep, jnep = gallery_pair("dep0", 40)
        lj = np.asarray(neptpu.iar(jnep, sigma=0.0, neigs=6, maxit=40,
                                   v=np.ones(40), tol=1e-12)[0])
        maxit = 30
    else:
        tnep, lj = dep0
        maxit = 40
    kw = {} if inner is None else dict(
        inner_solver_method=getattr(neptpu_torch, inner)())
    lams, Q, _ = getattr(neptpu_torch, name)(
        tnep, sigma=0.0, neigs=2, maxit=maxit, v=np.ones(tnep.n), tol=1e-10,
        proj_solve=True, check_error_every=5, device=CPU, **kw)
    assert len(lams) == 2 and Q.shape == (tnep.n, 2)
    assert conj_set_gap(lams, lj) < GAP
    assert max(_resnorms(tnep, lams, Q)) < 1e-8
