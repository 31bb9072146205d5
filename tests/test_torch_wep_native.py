"""Port parity: the native waveguide ``WEP_FD`` — its Sylvester-form
Mlincomb, the Schur complement, the FFT Sylvester solve, the SMW
preconditioner, the three linear solvers and ``resinv``/``iar`` on it —
against the JAX package on the CPU, at small sizes.

Both packages are built from one spec (the JAX problem's parts, carried by
``wep_fd_from_arrays``) or from the same gallery call; inputs are made with
numpy from a seed."""
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, rel_err

import neptpu
import neptpu_torch
from neptpu.models.gallery import waveguide as jw
from neptpu_torch.interop import wep_fd_from_arrays
from neptpu_torch.models.gallery import waveguide as tw
from neptpu_torch.ops.linsolve import gmres_restarted

TAUSCH = dict(nx=11, nz=7, benchmark_problem="TAUSCH")
# a real SMW (N < nz) needs nx = nz + 4
JARL = dict(nx=25, nz=21, benchmark_problem="JARLEBRING")
TAUSCH_SMW = dict(nx=25, nz=21, benchmark_problem="TAUSCH")
LAM = -1.3 - 0.31j
SIGMA = -3 - 3.5j


def _pair(spec):
    """The native problem from both packages: the port's carried over from
    the JAX problem's parts."""
    j = neptpu.nep_gallery("waveguide", neptype="WEP", **spec)
    _, _, _, Km, Kp = jw._wavenumber(spec["nx"], spec["nz"],
                                     spec["benchmark_problem"], 0.1)
    t = wep_fd_from_arrays(dict(
        nx=j.nx, nz=j.nz, hx=j.hx, hz=j.hz, Dxx=np.asarray(j.Dxx),
        Dzz=np.asarray(j.Dzz), Dz=np.asarray(j.Dz), C1=j.C1, C2T=j.C2T,
        K=np.asarray(j.K), k_bar=j.k_bar, Km=Km, Kp=Kp), device=CPU)
    return t, j


@pytest.fixture(scope="module")
def tausch():
    return _pair(TAUSCH)


@pytest.fixture(scope="module")
def jarl():
    return _pair(JARL)


@pytest.fixture(scope="module")
def tausch_smw():
    return _pair(TAUSCH_SMW)


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_gallery_returns_the_native_problem_and_the_spec_agrees(tausch):
    t, j = tausch
    g = neptpu_torch.nep_gallery("waveguide", neptype="WEP", device=CPU,
                                 **TAUSCH)
    assert isinstance(g, neptpu_torch.WEP_FD)
    assert isinstance(g, neptpu_torch.WEP) and g.n == j.n == 91
    v = _crandn(np.random.default_rng(0), g.n)
    assert rel_err(g.Mlincomb(LAM, torch.as_tensor(v)).numpy(),
                   t.Mlincomb(LAM, torch.as_tensor(v)).numpy()) < 1e-15


@pytest.mark.parametrize("ncols,startder", [(1, 0), (3, 0), (3, 1), (5, 0)])
def test_mlincomb_matches_jax(tausch, ncols, startder):
    """Sylvester-form Mlincomb with up to 4 derivative columns (beyond the
    interior's second derivative only the boundary rows move): rel 1e-13."""
    t, j = tausch
    rng = np.random.default_rng(ncols + 10 * startder)
    V = _crandn(rng, j.n, ncols)
    a = rng.standard_normal(ncols)
    zt = t.Mlincomb(LAM, torch.as_tensor(V), a, startder=startder).numpy()
    zj = np.asarray(j.Mlincomb(LAM, V, a, startder=startder))
    assert rel_err(zt, zj) < 1e-13


def test_mlincomb_matches_the_ports_spmf_form(tausch):
    """The native and the SPMF format agree: 1e-14 on one column, 1e-13 on
    three derivative columns."""
    t, _ = tausch
    spmf = neptpu_torch.nep_gallery("waveguide", neptype="SPMF", device=CPU,
                                    **TAUSCH)
    x = torch.ones(t.n, dtype=torch.float64)
    z1 = neptpu_torch.compute_Mlincomb(spmf, LAM, x)
    z2 = neptpu_torch.compute_Mlincomb(t, LAM, x)
    assert rel_err(z2.numpy(), z1.numpy()) < 1e-14
    V = torch.as_tensor(np.random.default_rng(0).standard_normal((t.n, 3)))
    a = np.array([1.0, 0.5, -0.2])
    z1 = neptpu_torch.compute_Mlincomb(spmf, LAM, V, torch.as_tensor(a))
    z2 = neptpu_torch.compute_Mlincomb(t, LAM, V, a)
    assert rel_err(z2.numpy(), z1.numpy()) < 1e-13


def test_schur_complement_matvec_and_dense(tausch):
    t, j = tausch
    v = _crandn(np.random.default_rng(1), t.nx * t.nz)
    st = tw.SchurMatVec(t, LAM)(torch.as_tensor(v)).numpy()
    assert rel_err(st, jw.SchurMatVec(j, LAM)(v)) < 1e-13
    S = tw.construct_WEP_schur_complement(t, LAM)
    Sj = jw.construct_WEP_schur_complement(j, LAM).toarray()
    assert rel_err(S.numpy(), Sj) < 1e-13
    # the dense complement is the matvec's matrix, block columns too
    B = _crandn(np.random.default_rng(2), t.nx * t.nz, 3)
    assert rel_err(tw.SchurMatVec(t, LAM)(torch.as_tensor(B)).numpy(),
                   S.numpy() @ B) < 1e-13


def test_sylvester_fft_batched_and_single(tausch_smw):
    """The batched FFT Sylvester solve equals JAX's one-by-one solves and
    the port's own single solves: rel 1e-12."""
    t, j = tausch_smw
    C = _crandn(np.random.default_rng(3), 4, t.nz, t.nx)
    Yb = tw.solve_wg_sylvester_fft(torch.as_tensor(C), SIGMA, t.k_bar, t.hx,
                                   t.hz).numpy()
    for i in range(4):
        Yj = jw.solve_wg_sylvester_fft(C[i], SIGMA, j.k_bar, j.hx, j.hz)
        Ys = tw.solve_wg_sylvester_fft(torch.as_tensor(C[i]), SIGMA, t.k_bar,
                                       t.hx, t.hz).numpy()
        assert rel_err(Yb[i], Yj) < 1e-12
        assert rel_err(Ys, Yj) < 1e-12


def _lu_reconstruct(lu, piv):
    """The matrix of a LAPACK (0-based) LU factorization."""
    n = lu.shape[0]
    A = np.tril(lu, -1) @ np.triu(lu) + np.triu(lu)
    perm = np.arange(n)
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    out = np.empty_like(A)
    out[perm] = A
    return out


def test_smw_matrix_matches_jax(jarl):
    """The SMW matrix at N = 7 < nz = 21 (mm = 77), entry by entry in JAX's
    index order, against JAX's LU-reconstructed M; and the port's own LU
    reproduces its M: rel 1e-12."""
    t, j = jarl
    Mt = tw.smw_system_matrix(t, 7, SIGMA).numpy()
    Mj = _lu_reconstruct(*jw.generate_smw_matrix(j, 7, SIGMA))
    assert Mt.shape == (77, 77)
    assert rel_err(Mt, Mj) < 1e-12
    lu, piv = tw.generate_smw_matrix(t, 7, SIGMA)
    P, L, U = torch.lu_unpack(lu, piv)
    assert rel_err((P @ L @ U).numpy(), Mt) < 1e-13


def test_smw_preconditioner_exact_inverse(tausch):
    """At N = nz the SMW preconditioner inverts the Schur matvec: 1e-13."""
    t, _ = tausch
    precond = tw.wep_generate_preconditioner(t, 7, LAM)
    b1 = _crandn(np.random.default_rng(5), 77)
    b2 = precond(tw.SchurMatVec(t, LAM)(torch.as_tensor(b1)))
    assert rel_err(b2.numpy(), b1) < 1e-13


def test_smw_preconditioner_matches_jax(jarl):
    t, j = jarl
    v = _crandn(np.random.default_rng(6), t.nx * t.nz)
    pt = tw.wep_generate_preconditioner(t, 7, SIGMA)
    pj = jw.wep_generate_preconditioner(j, 7, SIGMA)
    assert rel_err(pt(torch.as_tensor(v)).numpy(), pj(v)) < 1e-12
    Ct = torch.as_tensor(v.reshape(t.nz, t.nx, order="F"))
    assert rel_err(tw.solve_smw(t, pt.M, Ct, SIGMA).numpy(),
                   jw.solve_smw(j, pj.M, v.reshape(t.nz, t.nx, order="F"),
                                SIGMA)) < 1e-12


def test_smw_constraints_raise(tausch):
    t, _ = tausch
    with pytest.raises(ValueError, match="nz/N integer"):
        tw.wep_generate_preconditioner(t, 3, LAM)
    odd = neptpu_torch.nep_gallery("waveguide", nx=9, nz=7, device=CPU,
                                   benchmark_problem="TAUSCH")
    with pytest.raises(ValueError, match="nx = nz \\+ 4"):
        tw.wep_generate_preconditioner(odd, 7, LAM)


@pytest.mark.parametrize("solver_type", [":factorized", ":backslash"])
def test_direct_solvers_match_jax(jarl, solver_type):
    """The dense LU of the Schur complement and the uncached solve, on one
    right-hand side and on a block of three (one call): rel 1e-12."""
    t, j = jarl
    rng = np.random.default_rng(7)
    b = _crandn(rng, t.n)
    B = _crandn(rng, t.n, 3)
    st = neptpu_torch.WEPLinSolverCreator(solver_type).create(t, SIGMA)
    sj = neptpu.WEPLinSolverCreator(solver_type).create(j, SIGMA)
    assert rel_err(st.solve(torch.as_tensor(b)).numpy(),
                   np.asarray(sj.solve(b))) < 1e-12
    X = st.solve(torch.as_tensor(B))
    assert X.shape == (t.n, 3)
    assert rel_err(X.numpy(), np.asarray(sj.solve(B))) < 1e-12
    r = t.Mlincomb(SIGMA, X[:, 1]).numpy()
    assert rel_err(r, B[:, 1]) < 1e-12


def test_gmres_with_smw_matches_jax(tausch_smw):
    """GMRES (scipy's restart 20 and stop rule) with the SMW(N = 7)
    preconditioner: the solution within rel 1e-8 of JAX's, the same Arnoldi
    step count as scipy's, the residual below 1e-8."""
    t, j = tausch_smw
    b = np.random.default_rng(2).standard_normal(t.n) + 0j
    pt = tw.wep_generate_preconditioner(t, 7, SIGMA)
    pj = jw.wep_generate_preconditioner(j, 7, SIGMA)
    st = tw.WEPGMRESLinSolver(t, SIGMA, preconditioner=pt, reltol=1e-10)
    sj = jw.WEPGMRESLinSolver(j, SIGMA, preconditioner=pj, reltol=1e-10)
    xt = st.solve(torch.as_tensor(b))
    xj = np.asarray(sj.solve(b))
    assert rel_err(xt.numpy(), xj) < 1e-8
    assert st.info == [0] and 0 < st.iterations[0] < 200
    r = neptpu_torch.compute_Mlincomb(t, SIGMA, xt).numpy()
    assert rel_err(r, b) < 1e-8


def test_gmres_restarted_is_scipys():
    """The device GMRES against scipy's on a small nonsymmetric system,
    preconditioned and not: the same iterate and step count."""
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(8)
    n = 60
    A = np.eye(n) * 4 + _crandn(rng, n, n) / np.sqrt(n)
    P = np.linalg.inv(np.diag(np.diag(A)) + np.triu(A, 1) * 0.5)
    b = _crandn(rng, n)
    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    for M in (None, P):
        count = []
        xs, info = spla.gmres(A, b, rtol=1e-11, restart=7, maxiter=50, M=M,
                              callback=lambda r: count.append(r),
                              callback_type="pr_norm")
        xt, info_t, its = gmres_restarted(
            lambda v: At @ v, torch.as_tensor(b), rtol=1e-11, restart=7,
            maxiter=50, psolve=None if M is None else (lambda v: Pt @ v))
        assert info_t == info == 0 and its == len(count)
        assert rel_err(xt.numpy(), xs) < 1e-12


def test_factorized_solver_exposes_its_lu(jarl):
    t, _ = jarl
    s = neptpu_torch.WEPLinSolverCreator().create(t, SIGMA)
    nxz = t.nx * t.nz
    assert s.lu.shape == (nxz, nxz) and s.piv.shape == (nxz,)
    with pytest.raises(ValueError, match="only be used"):
        neptpu_torch.WEPLinSolverCreator().create(
            neptpu_torch.nep_gallery("dep0", device=CPU), SIGMA)
    with pytest.raises(ValueError, match="Unknown type"):
        neptpu_torch.WEPLinSolverCreator(":lu").create(t, SIGMA)
    with pytest.raises(NotImplementedError, match="Mder"):
        t.Mder(SIGMA)


def test_resinv_and_iar_on_the_native_problem(jarl):
    """resinv and iar with the factorized Schur solver at nx = 25, nz = 21:
    the same eigenvalues as the JAX package's, within 1e-10."""
    t, j = jarl
    v0 = np.ones(t.n) / np.sqrt(t.n)
    kw = dict(sigma=SIGMA, neigs=3, maxit=60, v=v0, tol=1e-8)
    lj, _, _ = neptpu.iar(j, linsolvercreator=neptpu.WEPLinSolverCreator(),
                          **kw)
    lt, Qt, _ = neptpu_torch.iar(
        t, linsolvercreator=neptpu_torch.WEPLinSolverCreator(), device=CPU,
        **kw)
    lj = np.sort_complex(np.asarray(lj))
    assert len(lt) == 3
    assert np.max(np.abs(np.sort_complex(lt) - lj)) < 1e-10
    for s in range(3):
        assert float(neptpu_torch.compute_resnorm(t, lt[s], Qt[:, s])) < 1e-6
    lam0 = complex(lj[-1]) + 0.05
    rj, _ = neptpu.resinv(j, lam=lam0, v=v0, tol=1e-12,
                          linsolvercreator=neptpu.WEPLinSolverCreator())
    rt, vt = neptpu_torch.resinv(
        t, lam=lam0, v=v0, tol=1e-12, device=CPU,
        linsolvercreator=neptpu_torch.WEPLinSolverCreator())
    assert abs(complex(rt) - complex(rj)) < 1e-10
    assert float(neptpu_torch.compute_resnorm(t, rt, vt)) / float(
        torch.linalg.vector_norm(vt)) < 1e-10
