"""Port parity: the rest of the gallery — the fixed examples, the native
NLEVP problems, the spectral-collocation Orr-Sommerfeld problem, the
low-rank sums, the periodic delay problems, the Fichera BEM problem, the
DtN dimer loader and the NLEVP bridge's error path — against the JAX
package on the CPU: ``Mder`` and ``Mlincomb`` at two points each, and the
oracles the JAX package's tests pin."""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import CPU, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.models.gallery import GALLERY

# (name, args, kwargs, two evaluation points, derivatives held)
CASES = [
    ("real_quadratic", (), {}, (-3.0, 1.5 + 0.5j), (0, 1, 2)),
    ("qdep0", (), {}, (0.3, -0.2 + 0.4j), (0, 1)),
    ("qdep1", (), {}, (0.3, -0.2 + 0.4j), (0, 1)),
    ("neuron0", (), {}, (0.3, -0.2 + 0.4j), (0, 1)),
    ("beam", (40,), {}, (-1.0, 0.5j), (0, 1)),
    ("sine", (), {}, (0.1, 0.2 + 0.1j), (0, 1)),
    # near -V0 the cosh/sinh arguments stay small: the JAX package's
    # expm loses ~1e-9 of exp(18.5) at lam = -3
    ("schrodinger_movebc", (60,), {}, (-9.9, -9.7 + 0.1j), (0, 1)),
    ("nlevp_native_cd_player", (), {}, (0.3, -1e3 + 10j), (0, 1)),
    ("nlevp_native_fiber", (), {}, (1e-6, 7e-7 + 1e-8j), (0, 1)),
    ("nlevp_native_hadeler", (), {}, (0.3, 2 + 1j), (0, 1)),
    ("nlevp_native_pdde_stability", (6,), {}, (0.3, 1 + 0.5j), (0, 1)),
    ("periodicdde", (), {"name": "mathieu", "N": 200}, (-0.24, -0.5 + 1j),
     (0, 1)),
    ("periodicdde", (), {"name": "milling1_be"}, (0.3, 0.1 + 0.2j), (0,)),
    ("periodicdde", (), {"name": "rand0", "n": 6, "N": 50}, (0.3, 0.1j),
     (0,)),
    ("bem_fichera", (1,), {}, (3.0, 8.79 - 0.01j), (0, 1, 2)),
    ("orr_sommerfeld", (24,), {}, (0.3, 0.31 + 0.01j), (0, 1)),
]


def _dense(M):
    M = M.to_dense() if hasattr(M, "to_dense") else M
    return M.numpy() if isinstance(M, torch.Tensor) else np.asarray(M)


@pytest.mark.parametrize("name,args,kwargs,lams,ders", CASES,
                         ids=[c[0] + "-" + c[2].get("name", "")
                              for c in CASES])
def test_mder_and_mlincomb_match_jax(name, args, kwargs, lams, ders):
    """``Mder`` (the derivatives the problem holds) and a two-column
    ``Mlincomb`` (one column where the problem takes one) at two points:
    rel 1e-13."""
    tn = neptpu_torch.nep_gallery(name, *args, device=CPU, **kwargs)
    jn = neptpu.nep_gallery(name, *args, **kwargs)
    assert tn.n == jn.n
    rng = np.random.default_rng(len(name))
    ncols = 1 if kwargs.get("name") == "milling1_be" else 2
    for lam in lams:
        for der in ders:
            Mj = _dense(jn.Mder(lam, der))
            Mt = _dense(tn.Mder(lam, der))
            assert rel_err(Mt, Mj) < 1e-13, (lam, der)
        V = rng.standard_normal((jn.n, ncols))
        a = np.array([1.0, 0.5])[:ncols]
        zj = np.asarray(neptpu.compute_Mlincomb(jn, lam, V, a))
        zt = neptpu_torch.compute_Mlincomb(tn, lam, torch.as_tensor(V), a)
        assert rel_err(zt.numpy(), zj) < 1e-13, lam


def test_gallery_keys_equal_jax():
    assert set(GALLERY) == set(neptpu.models.gallery.GALLERY)
    assert len(GALLERY) == 30
    neptpu_torch.models.gallery.register("dep0_again", GALLERY["dep0"])
    try:
        assert neptpu_torch.nep_gallery("dep0_again", device=CPU).n == 5
    finally:
        del GALLERY["dep0_again"]


def test_real_quadratic_four_real_eigenvalues():
    nep = neptpu_torch.nep_gallery("real_quadratic", device=CPU)
    lams, _ = neptpu_torch.polyeig(nep)
    lams = np.asarray(lams)
    for ref in (-2051.741417993845, -182.101627437811, -39.344930222838,
                -4.039879577113):
        assert np.min(np.abs(lams - ref)) < 1e-9 * abs(ref)


def test_orr_sommerfeld_oracle():
    """Scaled PEP + TIAR reproduces the Schmid & Henningson Table 7.1
    eigenvalues at n = 128 (Re = 2000, omega = 0.3)."""
    nep = neptpu_torch.nep_gallery("orr_sommerfeld", 128, device=CPU)
    sc = 100.0
    nep1 = neptpu_torch.shift_and_scale(nep, scale=sc)
    Av = [_dense(A) for A in nep1.get_Av()]
    ms = np.linalg.norm(Av[-1])
    nep2 = neptpu_torch.PEP([A / ms for A in Av], device=CPU)
    lam, _, _ = neptpu_torch.tiar(nep2, sigma=0.006, v=np.ones(nep.n),
                                  neigs=10, maxit=200, tol=1e-14, device=CPU)
    lam = sc * np.asarray(lam)
    for ref in (0.30865495875240445 + 0.008960297181538185j,
                0.3765784040323032 + 0.09959915134763689j,
                0.4087137042139992 + 0.15906877547743775j,
                -0.2863097014631293 - 0.9011417554715162j):
        assert np.min(np.abs(lam - ref)) < 1e-8 * abs(ref)


def test_chebyshev_matrices_match_jax():
    from neptpu.models.gallery import chebdiff as jc
    from neptpu_torch.models.gallery import chebdiff as tc

    x1, D1 = tc.chebdif(17, 3)
    x2, D2 = jc.chebdif(17, 3)
    assert np.array_equal(x1, x2)
    assert all(np.array_equal(a, b) for a, b in zip(D1, D2))
    assert all(np.array_equal(a, b) for a, b in zip(tc.cheb4c(17),
                                                     jc.cheb4c(17)))
    with pytest.raises(ValueError, match="0 < m"):
        tc.chebdif(5, 5)


def test_periodicdde_mathieu_oracle():
    """resinv converges to the pinned mathieu eigenvalue
    -0.24470143590830754."""
    nep = neptpu_torch.nep_gallery("periodicdde", name="mathieu",
                                   device=CPU)
    lam, v = neptpu_torch.resinv(
        nep, lam=-0.2447, v=np.array([0.970208 + 0j, -0.242272 + 0j]),
        tol=np.finfo(float).eps * 10, maxit=100, device=CPU)
    assert abs(complex(lam) - (-0.24470143590830754)) < 1e-10
    assert float(neptpu_torch.compute_resnorm(nep, lam, v)) < 1e-12
    with pytest.raises(ValueError, match="Unknown PeriodicDDE_NEP"):
        neptpu_torch.nep_gallery("periodicdde", name="nope", device=CPU)


def test_bem_fichera_oracle():
    """The pinned eigenvalue 8.790558462139456 - 0.010815457827738698i
    makes M singular; the first derivative agrees with central
    differences."""
    nep = neptpu_torch.nep_gallery("bem_fichera", 1, device=CPU)
    M = nep.Mder(8.790558462139456 - 0.010815457827738698j).numpy()
    s = np.linalg.svd(M, compute_uv=False)
    assert s[-1] / s[0] < 1e-10
    eps = 1e-6
    fd = (nep.Mder(9.0 + eps) - nep.Mder(9.0 - eps)).numpy() / (2 * eps)
    assert rel_err(nep.Mder(9.0, 1).numpy(), fd) < 1e-4


def test_native_nlevp_oracles():
    cd = neptpu_torch.nep_gallery("nlevp_native_cd_player", device=CPU)
    lam, v = neptpu_torch.newton(cd, lam=-1e5, v=np.ones(cd.n), maxit=50,
                                 tol=1e-10, device=CPU)
    assert float(neptpu_torch.compute_resnorm(cd, lam, v)) / float(
        torch.linalg.vector_norm(v)) < 1e-6
    had = neptpu_torch.nep_gallery("nlevp_native_hadeler", device=CPU)
    lam, v = neptpu_torch.mslp(had, lam=10.0, tol=1e-10, device=CPU)
    assert float(neptpu_torch.compute_resnorm(had, lam, v)) < 1e-6
    pd = neptpu_torch.nep_gallery("nlevp_native_pdde_stability", device=CPU)
    lams, V = neptpu_torch.polyeig(pd)
    i = int(np.argmin(np.abs(np.asarray(lams) - 1.0)))
    r = float(neptpu_torch.compute_resnorm(pd, lams[i], V[:, i]))
    assert r / float(torch.linalg.vector_norm(V[:, i])) < 1e-8
    # the fiber oracle 7.139494306065948e-07 (quasinewton's first step
    # from 7.14e-7 lands at -8e-4, where the Newton interpolant is
    # extrapolated and rounding decides the path; augnewton stays close)
    fib = neptpu_torch.nep_gallery("nlevp_native_fiber", device=CPU)
    lam, v = neptpu_torch.augnewton(fib, lam=7.14e-7, v=np.ones(fib.n),
                                    maxit=100, armijo_factor=0.5,
                                    armijo_max=10, device=CPU)
    assert abs(complex(lam) - 7.139494306065948e-07) < 1e-10
    beam = neptpu_torch.nep_gallery("beam", 50, device=CPU)
    lam, v = neptpu_torch.augnewton(beam, lam=-1.0, v=np.ones(beam.n),
                                    maxit=50, tol=1e-10, device=CPU)
    nrm = float(neptpu_torch.compute_resnorm(beam, lam, v))
    assert nrm < 1e-8 * float(torch.linalg.matrix_norm(
        beam.Mder_dense(lam)))


def test_files_that_wait_for_a_download_raise_the_jax_errors():
    with pytest.raises(FileNotFoundError, match="gun_K"):
        neptpu.nep_gallery("nlevp_native_gun")
    with pytest.raises(FileNotFoundError, match="gun_K"):
        neptpu_torch.nep_gallery("nlevp_native_gun", device=CPU)
    for pkg in (neptpu, neptpu_torch):
        with pytest.raises(FileNotFoundError, match="dtn_dimer data not"):
            pkg.nep_gallery("dtn_dimer", "/nonexistent/dir")
    from neptpu.models.gallery.nlevp_bridge import nlevp_gallery_import as j
    from neptpu_torch.models.gallery.nlevp_bridge import (
        nlevp_gallery_import as t)

    for imp in (j, t):
        with pytest.raises(ImportError, match="matlab.engine"):
            imp("gun")


def _petsc_matrix(path, A):
    A = sp.csr_matrix(A)
    with open(path, "wb") as f:
        np.array([1211216, A.shape[0], A.shape[1], A.nnz], ">i4").tofile(f)
        np.diff(A.indptr).astype(">i4").tofile(f)
        A.indices.astype(">i4").tofile(f)
        A.data.astype(">c16").tofile(f)


def _petsc_vector(path, x):
    with open(path, "wb") as f:
        np.array([1211214, len(x)], ">i4").tofile(f)
        np.asarray(x, dtype=">c16").tofile(f)


@pytest.fixture(scope="module")
def dimer_dir(tmp_path_factory):
    """A synthetic DtN dimer data set in PETSc's binary format: a 1D
    Laplacian K, a mass matrix M and five boundary vectors q1..q5."""
    d = tmp_path_factory.mktemp("dimer")
    n = 12
    rng = np.random.default_rng(0)
    K = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]) * (1 + 0.1j)
    _petsc_matrix(d / "K.bin", K)
    _petsc_matrix(d / "M.bin", sp.diags(1 + 0.1 * rng.random(n)))
    for i in range(1, 6):
        q = np.zeros(n, dtype=complex)
        q[8:] = rng.standard_normal(4) + 1j * rng.standard_normal(4)
        _petsc_vector(d / f"q{i}.bin", q)
    return str(d)


def test_dtn_dimer_from_petsc_files(dimer_dir):
    """The PETSc reader, the Bessel-quotient term and the loader on files
    the test writes: the same matrices and Mlincomb as the JAX package's."""
    from neptpu.models.gallery import dtn_dimer as jd
    from neptpu_torch.models.gallery import dtn_dimer as td

    K1 = td.naive_petsc_read(os.path.join(dimer_dir, "K.bin"))
    K2 = jd.naive_petsc_read(os.path.join(dimer_dir, "K.bin"))
    assert (K1 != K2).nnz == 0 and K1.shape == (12, 12)
    q1 = td.naive_petsc_read(os.path.join(dimer_dir, "q1.bin"))
    assert np.array_equal(q1, jd.naive_petsc_read(
        os.path.join(dimer_dir, "q1.bin")))
    for nu, s in ((0, 2.0 + 0.3j), (2, 5.0 - 0.1j)):
        assert td.besselh_quotient(nu, s) == jd.besselh_quotient(nu, s)
        assert td.besselh_quotient_der(nu, s) == jd.besselh_quotient_der(
            nu, s)
    tn = neptpu_torch.nep_gallery("dtn_dimer", dimer_dir, device=CPU)
    jn = neptpu.nep_gallery("dtn_dimer", dimer_dir)
    rng = np.random.default_rng(1)
    V = rng.standard_normal((12, 2)) + 0j
    for lam in (2.0 + 0.3j, 4.0 - 0.2j):
        zj = np.asarray(neptpu.compute_Mlincomb(jn, lam, V, np.ones(2)))
        zt = neptpu_torch.compute_Mlincomb(tn, lam, torch.as_tensor(V),
                                           np.ones(2))
        assert rel_err(zt.numpy(), zj) < 1e-13
        for der in (0, 1):
            assert rel_err(tn.nep2.Mder_dense(lam, der).numpy(),
                           np.asarray(jn.nep2.Mder_dense(lam, der))) < 1e-13
    with pytest.raises(ValueError, match="class_id"):
        bad = os.path.join(dimer_dir, "bad.bin")
        np.array([7, 1], ">i4").tofile(bad)
        td.naive_petsc_read(bad)


def test_fiber_quasinewton_parts_only_in_the_first_solve():
    """Where the two packages' ``quasinewton`` on fiber from 7.14e-7 part:
    every ingredient of its first step (M(lam0), u = M(lam0) v,
    w = M'(lam0) v, the Newton correction of lam) is the same to the last
    bit or to rounding, and the linear solve dv = -M(lam0)^-1 z, of a matrix
    with condition ~8e10, is backward stable in both (the port's getrf and
    the JAX package's LAPACK) but parts at ~3e-8 relative, which the next
    step's lam update amplifies."""
    from neptpu.ops.linsolve import FactorizeLinSolver as JSolver
    from neptpu_torch.ops.linsolve import FactorizeLinSolver as TSolver

    import jax.numpy as jnp

    jn = neptpu.nep_gallery("nlevp_native_fiber")
    tn = neptpu_torch.nep_gallery("nlevp_native_fiber", device=CPU)
    lam0 = 7.14e-7 + 0j
    v = np.ones(tn.n, dtype=complex)
    one_j, one_t = jnp.ones((1,)), torch.ones(1)
    u = [np.asarray(neptpu.compute_Mlincomb(jn, lam0, jnp.asarray(v)[:, None],
                                            one_j, startder=d))
         for d in (0, 1)]
    ut = [neptpu_torch.compute_Mlincomb(tn, lam0, torch.as_tensor(v)[:, None],
                                        one_t, startder=d).numpy()
          for d in (0, 1)]
    for a, b in zip(ut, u):
        assert rel_err(a, b) < 1e-15
    M = tn.Mder_dense(lam0).numpy()
    assert rel_err(M, np.asarray(jn.Mder_dense(lam0))) < 1e-15
    assert np.linalg.cond(M) > 1e10
    z = (-np.vdot(v, u[0]) / np.vdot(v, u[1])) * u[1] + u[0]
    xj = np.asarray(JSolver(jn, jnp.asarray(lam0)).solve(jnp.asarray(z)))
    xt = TSolver(tn, torch.tensor(lam0)).solve(torch.as_tensor(z)).numpy()
    for x in (xj, xt):  # backward stable: below n eps = 5.3e-13
        back = np.linalg.norm(M @ x - z) / (
            np.linalg.norm(M, 2) * np.linalg.norm(x) + np.linalg.norm(z))
        assert back < 1e-13
    assert 1e-12 < rel_err(xt, xj) < 1e-2
