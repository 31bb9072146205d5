"""Port parity: projected NEPs (``set_projectmatrices``, the rank-1
``expand_projectmatrices``), the inner solvers on one projected problem,
``compute_rf`` through an InnerSolver, the linear eigensolvers, companion
linearizations and ``polyeig`` (monomial and Chebyshev), and the solvers
built on them (``mslp``, ``sgiter``, ``rfi``, ``rfi_b``), against the JAX
package on the CPU in complex128."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, conj_set_gap, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.ops.sparse import CSR

# the projected operands are sums of n products: rounding order only
RTOL = 1e-12


def _basis(n, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    return np.linalg.qr(X)[0]


def _B(pnep):
    k = pnep.n
    return np.asarray(pnep.B_mem)[:, :k, :k]


def _both_projections(tnep, jnep, k=4, seed=0):
    W, V = _basis(tnep.n, k + 1, seed), _basis(tnep.n, k + 1, seed + 1)
    tp = neptpu_torch.create_proj_NEP(tnep, maxsize=8)
    jp = neptpu.create_proj_NEP(jnep, maxsize=8)
    neptpu_torch.set_projectmatrices(tp, torch.from_numpy(W[:, :k]),
                                     torch.from_numpy(V[:, :k]))
    neptpu.set_projectmatrices(jp, W[:, :k], V[:, :k])
    yield tp, jp, W[:, :k], V[:, :k]
    neptpu_torch.expand_projectmatrices(tp, torch.from_numpy(W),
                                        torch.from_numpy(V))
    neptpu.expand_projectmatrices(jp, W, V)
    yield tp, jp, W, V


@pytest.mark.parametrize("deflated", [False, True])
def test_projection_matrices_match_jax(deflated):
    """B_i = W^H A_i V after a full projection and after the border update,
    on a DIA-banked DEP (the -lam I term a CSR identity) and on its deflated
    SPMF (padded DIA terms and low-rank factor terms)."""
    tnep, jnep = gallery_pair("dep_symm_double", 24)
    assert isinstance(tnep.bank, DiaTermBank)
    assert isinstance(tnep.get_Av()[0], CSR)
    if deflated:
        v = np.random.default_rng(2).standard_normal(tnep.n) + 0j
        tnep = neptpu_torch.deflate_eigpair(tnep, -1.0, torch.from_numpy(v))
        jnep = neptpu.deflate_eigpair(jnep, -1.0, v)
    for tp, jp, W, V in _both_projections(tnep, jnep):
        assert tp.n == jp.n == V.shape[1]
        assert rel_err(_B(tp), _B(jp)) < RTOL
        assert isinstance(tp.W, torch.Tensor) and tp.W.device.type == "cpu"
        direct = W.conj().T @ np.asarray(jnep.Mder_dense(0.3 - 0.1j)) @ V
        assert rel_err(tp.Mder_dense(0.3 - 0.1j), direct) < 1e-11
        x = np.arange(1.0, V.shape[1] + 1) + 0j
        assert rel_err(neptpu_torch.compute_Mlincomb(tp, 0.3,
                                                     torch.from_numpy(x)),
                       neptpu.compute_Mlincomb(jp, 0.3, jnp.asarray(x))) < RTOL
    with pytest.raises(NotImplementedError, match="AbstractSPMF"):
        neptpu_torch.create_proj_NEP(neptpu_torch.models.deflation
                                     .DeflatedNEPMM(tnep, np.eye(1),
                                                    np.ones((tnep.n, 1))))


@pytest.fixture(scope="module")
def projected():
    """The same 5-dimensional projection of dep0 (n = 200) in both packages
    (the JAX package's inner-solver sweep)."""
    tnep, jnep = gallery_pair("dep0", 200)
    cols = np.asarray(neptpu.nep_gallery("pep0", 200).get_Av()[0])[:, 7:12]
    Q = np.linalg.qr(cols)[0]
    tp = neptpu_torch.create_proj_NEP(tnep, maxsize=6)
    jp = neptpu.create_proj_NEP(jnep, maxsize=6)
    tp.set_projectmatrices(torch.from_numpy(Q), torch.from_numpy(Q))
    jp.set_projectmatrices(Q, Q)
    return tp, jp


def _residuals(pnep, lamv, V, count):
    return [float(np.linalg.norm(neptpu_torch.compute_Mlincomb(
        pnep, complex(lamv[i]), torch.from_numpy(np.asarray(V[:, i]))))
        / np.linalg.norm(V[:, i])) for i in range(count)]


# each inner solver on the projected problem: the eigenvalues the JAX
# package's same inner solver returns (rel 1e-8: both iterate in complex128
# from the same start), residuals below the solver's tolerance
@pytest.mark.parametrize("name,kw,count,tol", [
    ("DefaultInnerSolver", dict(sigma=0.0, neigs=3, tol=1e-13), 3, 1e-10),
    ("IARInnerSolver", dict(sigma=0.0, neigs=3, tol=1e-13), 3, 1e-10),
    ("IARChebInnerSolver", dict(lamv=np.arange(4).astype(complex)), 4, 1e-6),
    ("NewtonInnerSolver", dict(lamv=np.array([0.0 + 0j, 1.0 + 0j]),
                               V=np.ones((5, 2)), tol=1e-13), 2, 1e-10),
])
def test_inner_solvers_match_jax(projected, name, kw, count, tol):
    from neptpu.solvers.inner import inner_solve as jinner

    from neptpu_torch.solvers.inner import _resolve

    tp, jp = projected
    lt, Vt = neptpu_torch.inner_solve(getattr(neptpu_torch, name)(),
                                      torch.complex128, tp, **kw)
    lj, Vj = jinner(getattr(neptpu, name)(), complex, jp, **kw)
    assert isinstance(lt, np.ndarray) and isinstance(Vt, np.ndarray)
    assert len(lt) == len(np.asarray(lj)) >= count
    assert conj_set_gap(lt[:count], np.asarray(lj)) < 1e-8
    assert max(_residuals(tp, lt, Vt, count)) < tol
    # the default for a projected DEP is the Chebyshev-labelled IAR
    assert isinstance(_resolve(None, tp), neptpu_torch.IARChebInnerSolver)


def test_polyeig_and_sgiter_inner_solvers_match_jax():
    """The PEP default (polyeig on the projected coefficients) and the
    safeguarded iteration."""
    from neptpu.solvers.inner import inner_solve as jinner

    tnep, jnep = gallery_pair("pep0_sym", 30)
    Q = _basis(30, 4, 5).real
    Q = np.linalg.qr(Q)[0]
    tp = neptpu_torch.create_proj_NEP(tnep, maxsize=4)
    jp = neptpu.create_proj_NEP(jnep, maxsize=4)
    tp.set_projectmatrices(torch.from_numpy(Q), torch.from_numpy(Q))
    jp.set_projectmatrices(Q, Q)
    lt, Vt = neptpu_torch.inner_solve(None, torch.complex128, tp, neigs=3)
    lj, _ = jinner(None, complex, jp, neigs=3)
    assert len(lt) == 4 * 2
    assert conj_set_gap(lt, np.asarray(lj)) < 1e-10
    assert max(_residuals(tp, lt, Vt, len(lt))) < 1e-10
    # the safeguarded iteration on the identity projection of a min-max
    # problem
    jnep = neptpu.nep_gallery("real_quadratic")
    tnep = neptpu_torch.PEP([np.asarray(A) for A in jnep.get_Av()],
                            device=CPU)
    tp = neptpu_torch.create_proj_NEP(tnep, maxsize=4)
    jp = neptpu.create_proj_NEP(jnep, maxsize=4)
    tp.set_projectmatrices(torch.eye(4), torch.eye(4))
    jp.set_projectmatrices(np.eye(4), np.eye(4))
    for j in (1, 2):
        lt, Vt = neptpu_torch.inner_solve(neptpu_torch.SGIterInnerSolver(),
                                          torch.float64, tp, j=j)
        lj, _ = jinner(neptpu.SGIterInnerSolver(), np.float64, jp, j=j)
        assert abs(lt[0] - complex(np.asarray(lj)[0])) < 1e-10 * abs(lt[0])
        assert Vt.shape == (4, 1)


@pytest.mark.parametrize("name", ["ContourBeynInnerSolver",
                                  "NleigsInnerSolver"])
def test_contour_and_nleigs_inner_solvers_are_not_ported_yet(projected, name):
    """(Named when these two raised; they are ported now.)  The contour and
    NLEIGS inner solvers on the projected problem return the JAX package's
    eigenvalues (rel 1e-9, as sets: NLEIGS's run to tol 1e-6 leaves two
    values unconverged, the same in both) and host arrays."""
    from neptpu.solvers.inner import inner_solve as jinner

    tp, jp = projected
    kw = (dict(lamv=np.array([0.0 + 0j, 1.0 + 0j]), neigs=3)
          if name == "ContourBeynInnerSolver"
          else dict(lamv=np.arange(4).astype(complex)))
    lt, Vt = neptpu_torch.inner_solve(getattr(neptpu_torch, name)(),
                                      torch.complex128, tp, **kw)
    lj, Vj = jinner(getattr(neptpu, name)(), jnp.complex128, jp, **kw)
    lj = np.asarray(lj)
    assert isinstance(Vt, np.ndarray) and Vt.shape == np.asarray(Vj).shape
    assert len(lt) == len(lj) >= 3
    for a, b in ((lt, lj), (lj, lt)):
        for x in a:
            assert np.min(np.abs(b - x)) <= 1e-9 * abs(x)
    if name == "ContourBeynInnerSolver":
        assert max(_residuals(tp, lt, Vt, 2)) < 1e-6


@pytest.mark.parametrize("inner", ["NewtonInnerSolver", "IARInnerSolver"])
def test_compute_rf_through_an_inner_solver_matches_jax(inner):
    tnep, jnep = gallery_pair("dep0")
    _, v = neptpu_torch.newton(tnep, lam=-0.5, v=np.ones(5), maxit=50,
                               device=CPU)
    x = v.numpy() + 0.01 * np.arange(1.0, 6.0)
    kw = dict(target=-0.2, lam=-0.2)
    rt = neptpu_torch.compute_rf(torch.complex128, tnep, torch.from_numpy(x),
                                 getattr(neptpu_torch, inner)(), **kw)
    rj = neptpu.compute_rf(jnp.complex128, jnep, jnp.asarray(x),
                           getattr(neptpu, inner)(), **kw)
    assert abs(rt[0] - complex(np.asarray(rj)[0])) < 1e-10


def test_factorization_of_a_singular_matrix_gives_nonfinite_solutions():
    """A small projected problem at its eigenvalue is exactly singular:
    the factorization, as LAPACK's in the JAX package, gives non-finite
    solutions for the error measure to judge instead of raising."""
    A = [np.array([[1.0, 0.0], [0.0, 0.0]]), np.zeros((2, 2))]
    ts = neptpu_torch.FactorizeLinSolver(neptpu_torch.PEP(A, device=CPU), 0.0)
    js = neptpu.FactorizeLinSolver(neptpu.PEP(A), 0.0)
    b = np.ones(2)
    xt = ts.solve(torch.from_numpy(b)).numpy()
    xj = np.asarray(js.solve(jnp.asarray(b)))
    assert not np.isfinite(xt).all() and not np.isfinite(xj).all()


# -- linear eigensolvers, companion, polyeig --------------------------------
def _sorted(D):
    D = np.asarray(D)
    return D[np.lexsort((D.imag, D.real))]


def _set_gap(a, b):
    """Largest relative distance from a value of either set to the other."""
    a, b = np.asarray(a), np.asarray(b)
    return max(max(np.min(np.abs(b - x)) / abs(x) for x in a),
               max(np.min(np.abs(a - y)) / abs(y) for y in b))


@pytest.mark.parametrize("cls", ["EigenEigSolver", "ArnoldiEigSolver",
                                 "DefaultEigSolver"])
@pytest.mark.parametrize("pencil", [False, True])
def test_eig_solvers_match_jax(cls, pencil):
    rng = np.random.default_rng(11)
    A = rng.standard_normal((60, 60))
    B = np.eye(60) + 0.1 * rng.standard_normal((60, 60)) if pencil else None
    tB = None if B is None else torch.from_numpy(B)
    jB = None if B is None else jnp.asarray(B)
    # a target off the real axis: no ties between conjugates at the cut
    Dt, Vt = neptpu_torch.eig_solve(getattr(neptpu_torch, cls)(
        torch.from_numpy(A), tB), nev=6, target=0.5 + 0.1j)
    Dj, _ = neptpu.eig_solve(getattr(neptpu, cls)(jnp.asarray(A), jB), nev=6,
                             target=0.5 + 0.1j)
    assert isinstance(Dt, torch.Tensor) and Vt.shape == (60, 6)
    # as sets: the order within a conjugate pair is the LAPACK call's
    assert _set_gap(Dt.numpy(), Dj) < 1e-9
    Bm = np.eye(60) if B is None else B
    for i in range(6):
        r = A @ Vt[:, i].numpy() - Dt[i].item() * Bm @ Vt[:, i].numpy()
        assert np.linalg.norm(r) < 1e-9 * np.linalg.norm(Vt[:, i].numpy())


def test_default_eig_solver_picks_as_the_jax_package():
    """Arnoldi for a CSR operand larger than 400, dense otherwise.  A DIA
    operand (a banded problem's ``compute_Mder``) takes the dense branch in
    both; the port forms it dense, the JAX package's dense branch cannot
    convert it and raises TypeError."""
    tnep, jnep = gallery_pair("dep_symm_double", 24)
    Mt, Mj = tnep.bank.term(0), jnep.bank.term(0)
    sub = neptpu_torch.DefaultEigSolver(Mt).sub
    assert isinstance(sub, neptpu_torch.EigenEigSolver)
    assert rel_err(sub.A, Mt.to_dense()) == 0.0
    with pytest.raises(TypeError):
        neptpu.DefaultEigSolver(Mj)
    tsp, jsp = gallery_pair("pep0_sparse", 500)
    assert isinstance(tsp.bank.term(0), CSR)
    assert isinstance(neptpu_torch.DefaultEigSolver(tsp.bank.term(0)).sub,
                      neptpu_torch.ArnoldiEigSolver)
    assert isinstance(neptpu.DefaultEigSolver(jsp.bank.term(0)).sub,
                      neptpu.ArnoldiEigSolver)


def test_companion_and_polyeig_match_jax():
    tnep, jnep = gallery_pair("pep0", 6)
    Et, At = neptpu_torch.companion(tnep)
    Ej, Aj = neptpu.companion(jnep)
    assert rel_err(Et, Ej) < RTOL and rel_err(At, Aj) < RTOL
    Dt, Vt = neptpu_torch.polyeig(tnep)
    Dj, _ = neptpu.polyeig(jnep)
    assert Vt.shape == (6, len(Dt)) == (6, 12)
    assert rel_err(_sorted(Dt), _sorted(Dj)) < 1e-10
    for i in range(len(Dt)):
        r = float(neptpu_torch.compute_resnorm(tnep, Dt[i].item(), Vt[:, i]))
        assert r < 1e-9 * float(torch.linalg.vector_norm(Vt[:, i]))


def test_chebpep_and_its_polyeig_match_jax():
    """The Chebyshev interpolant of dep0 on [-1, 1]: nodes, coefficients,
    compute functions and the colleague-matrix polyeig."""
    from neptpu.models import cheb as jcheb

    from neptpu_torch.models import cheb as tcheb

    tnep, jnep = gallery_pair("dep0")
    np.testing.assert_allclose(tcheb.chebyshev_nodes(-1, 2, 7),
                               jcheb.chebyshev_nodes(-1, 2, 7), rtol=RTOL)
    tc = neptpu_torch.ChebPEP(tnep, 9)
    jc = neptpu.ChebPEP(jnep, 9)
    # the coefficients are sums of 9 samples that cancel in the high orders:
    # each within 1e-12 of the largest coefficient
    big = max(np.linalg.norm(np.asarray(Bj)) for Bj in jc.get_Av())
    for Bt, Bj in zip(tc.get_Av(), jc.get_Av()):
        assert np.linalg.norm(Bt.numpy() - np.asarray(Bj)) < 1e-12 * big
    V = np.random.default_rng(12).standard_normal((5, 2)) + 0j
    assert rel_err(neptpu_torch.compute_Mlincomb(tc, 0.3, torch.from_numpy(V)),
                   neptpu.compute_Mlincomb(jc, 0.3, jnp.asarray(V))) < RTOL
    S = torch.tensor([[0.2, 1.0], [0.0, 0.2]], dtype=torch.complex128)
    for j in range(4):
        assert rel_err(tcheb.cheb_fun(-1, 2, j)(S),
                       jcheb.cheb_fun(-1, 2, j)(jnp.asarray(S.numpy()))) < RTOL
    Dt, Vt = neptpu_torch.polyeig(tc)
    Dj, _ = neptpu.polyeig(jc)
    inside = np.abs(np.asarray(Dj)) < 1.0
    assert rel_err(_sorted(Dt.numpy()[np.abs(Dt.numpy()) < 1.0]),
                   _sorted(np.asarray(Dj)[inside])) < 1e-8
    # dep0's eigenvalue -0.1596 is resolved by the interpolant
    assert np.min(np.abs(Dt.numpy() + 0.15955391823299)) < 1e-6
    assert torch.allclose(torch.linalg.vector_norm(Vt, dim=0),
                          torch.ones(Vt.shape[1], dtype=torch.float64))


# -- the solvers on the linear eigensolver and the Rayleigh functional ------
@pytest.fixture(scope="module")
def dep0():
    return gallery_pair("dep0")


def test_mslp_matches_jax(dep0):
    tnep, jnep = dep0
    eps = 2.0**-52
    lt, vt = neptpu_torch.mslp(tnep, tol=eps * 100, device=CPU)
    lj, _ = neptpu.mslp(jnep, tol=eps * 100)
    assert isinstance(lt, complex) and vt.shape == (5,)
    assert abs(lt - complex(lj)) < 1e-12
    assert float(neptpu_torch.compute_resnorm(tnep, lt, vt)) < eps * 500
    lr, _ = neptpu_torch.mslp(tnep, dtype=torch.float64, tol=1e-12,
                              device=CPU)
    assert isinstance(lr, float) and abs(lr - lt.real) < 1e-10


def test_sgiter_matches_jax():
    jnep = neptpu.nep_gallery("real_quadratic")
    tnep = neptpu_torch.PEP([np.asarray(A) for A in jnep.get_Av()],
                            device=CPU)
    lt, vt = neptpu_torch.sgiter(tnep, 1, lam_min=-10, lam_max=0, lam=-10,
                                 maxit=100, tol=1e-12, device=CPU)
    lj, _ = neptpu.sgiter(jnep, 1, lam_min=-10, lam_max=0, lam=-10,
                          maxit=100, tol=1e-12)
    assert abs(lt - float(lj)) < 1e-10 * abs(lt)
    assert -10 <= lt <= 0
    assert float(torch.linalg.vector_norm(
        neptpu_torch.compute_Mlincomb(tnep, lt, vt))) < 1e-9
    with pytest.raises(ValueError, match="proper interval"):
        neptpu_torch.sgiter(tnep, 1, lam_min=-10, device=CPU)


@pytest.mark.parametrize("name", ["rfi", "rfi_b"])
def test_rfi_matches_jax(dep0, name):
    tnep, jnep = dep0
    A = [np.asarray(a).T for a in jnep.bank.A]
    tnept = neptpu_torch.DEP(A, tnep.tauv, device=CPU)
    jnept = neptpu.DEP(A, np.asarray(jnep.tauv))
    kw = dict(v=np.ones(5), u=np.ones(5), tol=1e-13)
    lt, xt, yt = getattr(neptpu_torch, name)(tnep, tnept, device=CPU, **kw)
    lj, _, _ = getattr(neptpu, name)(jnep, jnept, **kw)
    assert abs(lt - complex(lj)) < 1e-10 * abs(lt)
    assert float(neptpu_torch.compute_resnorm(tnep, lt, xt)) < 1e-11
    if name == "rfi":  # the bordered variant's left vector is not held so
        assert float(neptpu_torch.compute_resnorm(tnept, lt, yt)) < 1e-11
