"""Port parity: the protocol solvers (``iar``, ``tiar``, the Newton family),
the Rayleigh functional, the error measures and the loggers, against the JAX
package on the CPU in complex128."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, conj_set_gap, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.core import errmeasure as tem
from neptpu_torch.core.logger import ErrorLogger, PrintLogger, parse_logger
from neptpu_torch.solvers import common
from neptpu_torch.solvers.rf import PolyRF, ScalarNewtonRF, compute_rf


@pytest.fixture(scope="module")
def dep0():
    return gallery_pair("dep0")


@pytest.fixture(scope="module")
def tridiag():
    return gallery_pair("dep0_tridiag", 64)


# converged eigenvalues as sets modulo conjugation (the problem is real);
# both sides iterate in complex128 from the same start vector
@pytest.mark.parametrize("name", ["iar", "tiar"])
@pytest.mark.parametrize("kw", [dict(), dict(check_error_every=5)])
def test_krylov_protocol_solvers_match_jax(tridiag, name, kw):
    tnep, jnep = tridiag
    args = dict(sigma=-0.2, maxit=30, neigs=3, v=np.ones(64), **kw)
    lj, Qj, Vj = getattr(neptpu, name)(jnep, **args)
    lt, Qt, Vt = getattr(neptpu_torch, name)(tnep, device=CPU, **args)
    assert len(lt) == len(lj) == 3
    assert conj_set_gap(lt, lj) < 1e-9 and conj_set_gap(lj, lt) < 1e-9
    assert isinstance(Qt, torch.Tensor) and Qt.shape == (64, 3)
    assert Vt.shape == tuple(np.asarray(Vj).shape)
    em = tem.DefaultErrmeasure(tnep)
    assert max(em(lt[i], Qt[:, i]) for i in range(3)) < 1e4 * 2.3e-16


@pytest.mark.parametrize("name", ["iar", "tiar"])
def test_krylov_protocol_solvers_report_partial_results(tridiag, name):
    tnep, _ = tridiag
    solver = getattr(neptpu_torch, name)
    with pytest.raises(neptpu_torch.NoConvergenceException) as exc:
        solver(tnep, sigma=-0.2, maxit=6, neigs=5, v=np.ones(64), device=CPU)
    assert len(exc.value.lam) == 5 and "maxit=6" in str(exc.value)
    # proj_solve: the Ritz values refined on the projected problem are the
    # JAX package's eigenvalues of the same problem
    lp = solver(tnep, sigma=-0.2, maxit=20, neigs=2, v=np.ones(64),
                proj_solve=True, check_error_every=5, device=CPU)[0]
    lj = neptpu.iar(tridiag[1], sigma=-0.2, maxit=30, neigs=3,
                    v=np.ones(64))[0]
    assert len(lp) == 2 and conj_set_gap(lp, np.asarray(lj)) < 1e-9
    # a class is instantiated, an instance used, a callable called
    ref = solver(tnep, sigma=-0.2, maxit=20, neigs=2, v=np.ones(64),
                 device=CPU)[0]
    for orth in (neptpu_torch.ModifiedGS, neptpu_torch.ClassicalGS(),
                 lambda V, w: neptpu_torch.orthogonalize_and_normalize(V, w)):
        lams = solver(tnep, sigma=-0.2, maxit=20, neigs=2, v=np.ones(64),
                      orthmethod=orth, device=CPU)[0]
        assert conj_set_gap(lams, ref) < 1e-8


def test_tiar_refuses_a_problem_smaller_than_its_basis(dep0):
    with pytest.raises(neptpu_torch.LostOrthogonalityException):
        neptpu_torch.tiar(dep0[0], maxit=30, device=CPU)


NEWTONS = ["newton", "augnewton", "resinv", "quasinewton", "newtonqr",
           "implicitdet"]


# the same iteration in complex128 from the same start: the eigenvalue to
# rel 1e-10, the error measure below the solvers' default tolerance
@pytest.mark.parametrize("name", NEWTONS)
def test_newton_family_matches_jax_on_dep0(dep0, name):
    tnep, jnep = dep0
    kw = dict(lam=-0.5, v=np.ones(5), maxit=50)
    jout = getattr(neptpu, name)(jnep, **kw)
    tout = getattr(neptpu_torch, name)(tnep, device=CPU, **kw)
    lam, v = tout[0], tout[1]
    assert isinstance(lam, complex) and v.dtype == torch.complex128
    assert abs(lam - complex(np.asarray(jout[0]))) < 1e-10 * abs(lam)
    res = float(neptpu_torch.compute_resnorm(tnep, lam, v)
                / torch.linalg.vector_norm(v))
    assert res < 1e-10
    if name == "newtonqr":
        assert len(tout) == 3 and tout[2].shape == (5,)


@pytest.mark.parametrize("name", ["newton", "augnewton", "resinv",
                                  "quasinewton", "implicitdet"])
def test_newton_family_in_real_arithmetic(dep0, name):
    tnep, _ = dep0
    lam, v = getattr(neptpu_torch, name)(
        tnep, dtype=torch.float64, lam=-0.5, v=np.ones(5), maxit=50,
        device=CPU)[:2]
    assert isinstance(lam, float) and v.dtype == torch.float64
    assert abs(lam - (-0.15955391823299)) < 1e-10


def test_resinv_basin_and_divergence(dep0):
    tnep, jnep = dep0
    lam, v = neptpu_torch.resinv(tnep, lam=-0.5, v=np.ones(5), device=CPU)
    assert float(neptpu_torch.compute_resnorm(tnep, lam, v)) < 1e-10
    # outside the basin the iteration explodes through the exp term: that
    # surfaces as non-convergence with the last iterate, never OverflowError
    with pytest.raises(neptpu_torch.NoConvergenceException) as exc:
        neptpu_torch.resinv(tnep, lam=-0.7, v=np.ones(5), device=CPU)
    assert exc.value.lam is not None and exc.value.v.shape == (5,)
    with pytest.raises(neptpu.NoConvergenceException):
        neptpu.resinv(jnep, lam=-0.7, v=np.ones(5))


def test_armijo_and_options(dep0):
    tnep, _ = dep0
    ref = neptpu_torch.augnewton(tnep, lam=-0.5, v=np.ones(5), device=CPU)[0]
    for kw in (dict(armijo_factor=0.5, armijo_max=3), dict(c=np.zeros(5)),
               dict(c=np.arange(1.0, 6.0)),
               dict(linsolvercreator=neptpu_torch.BackslashLinSolverCreator)):
        # another normalization may lead to another eigenvalue of dep0
        lam, v = neptpu_torch.augnewton(tnep, lam=-0.5, v=np.ones(5),
                                        maxit=60, device=CPU, **kw)
        assert float(neptpu_torch.compute_resnorm(tnep, lam, v)
                     / torch.linalg.vector_norm(v)) < 1e-10
    lam, _ = neptpu_torch.resinv(tnep, lam=-0.5, v=np.ones(5),
                                 c=np.zeros(5), device=CPU)
    assert abs(lam - ref) < 1e-9
    dlam, dv, j, scale = common.armijo_rule(
        tnep, lambda lam, v: abs(lam), 0.5, 0.0, torch.ones(5), 4.0,
        torch.ones(5), 0.5, 5)
    assert (dlam, j, scale) == (0.5, 3, 0.125)
    assert common.closest_to([1.0, 2.5, -1.0], 2.0) == 2.5
    assert common.default_tol(torch.complex128) == 100 * 2.0**-52


def test_compute_rf_matches_jax(dep0):
    tnep, jnep = dep0
    # a vector near an eigenvector: the scalar Newton iteration on
    # x^H M(lam) x is well conditioned there
    _, v = neptpu_torch.newton(tnep, lam=-0.5, v=np.ones(5), maxit=50,
                               device=CPU)
    x = v.numpy() + 0.01 * np.arange(1.0, 6.0)
    r = compute_rf(torch.complex128, tnep, torch.from_numpy(x), lam=-0.3)
    rj = neptpu.compute_rf(jnp.complex128, jnep, jnp.asarray(x), lam=-0.3)
    assert abs(r[0] - np.asarray(rj)[0]) < 1e-10
    assert abs(r[0]) < 1.0  # stays near the eigenvalue -0.1596
    with pytest.raises(neptpu_torch.NoConvergenceException):
        compute_rf(torch.complex128, tnep, torch.from_numpy(x), lam=-0.3,
                   inner_solver=ScalarNewtonRF(maxit=1,
                                               bad_solution_allowed=False))
    tpep, jpep = gallery_pair("pep0", 6)
    x = np.ones(6) + 0j
    r = compute_rf(torch.complex128, tpep, torch.from_numpy(x), PolyRF(),
                   target=0.2)
    rj = np.asarray(neptpu.compute_rf(jnp.complex128, jpep, jnp.asarray(x),
                                      target=0.2))
    assert rel_err(r, rj) < 1e-10


def test_errmeasures_match_jax(tridiag):
    tnep, jnep = tridiag
    rng = np.random.default_rng(5)
    v = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    lam = -0.3 + 0.2j
    from neptpu.core import errmeasure as jem

    for cls in ("ResidualErrmeasure", "StandardSPMFErrmeasure"):
        a = getattr(tem, cls)(tnep)(lam, torch.from_numpy(v))
        b = float(getattr(jem, cls)(jnep)(lam, jnp.asarray(v)))
        assert isinstance(a, float) and abs(a - b) < 1e-12 * b
    assert isinstance(tem.DefaultErrmeasure(tnep), tem.StandardSPMFErrmeasure)
    # a diverged (zero or non-finite) iterate measures nan/inf, no exception
    assert not np.isfinite(tem.ResidualErrmeasure(tnep)(
        lam, torch.zeros(64, dtype=torch.complex128)))
    assert not np.isfinite(tem.StandardSPMFErrmeasure(tnep)(
        lam, torch.zeros(64, dtype=torch.complex128)))
    assert tem.EigvalReferenceErrmeasure(tnep, 1.0)(1.5j, None) == abs(
        1.5j - 1.0)
    assert isinstance(tem.make_errmeasure(tem.ResidualErrmeasure, tnep),
                      tem.ResidualErrmeasure)
    f = lambda lam, v: 0.25  # noqa: E731
    assert tem.estimate_error(tem.make_errmeasure(f, tnep), 0, None) == 0.25


def test_loggers(tridiag, capsys):
    tnep, _ = tridiag
    log = ErrorLogger(maxits=40, maxvals=40)
    neptpu_torch.tiar(tnep, sigma=-0.2, maxit=20, neigs=2, v=np.ones(64),
                      logger=log, device=CPU)
    assert np.isfinite(log.errs[2, :2]).all() and np.isnan(log.errs[2, 2])
    neptpu_torch.newton(tnep, lam=-0.29, v=np.ones(64), logger=1, maxit=30,
                        device=CPU)
    assert "iter 0 err=" in capsys.readouterr().out
    assert isinstance(parse_logger(None), PrintLogger)
    assert parse_logger(log) is log
