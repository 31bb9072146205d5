"""Port parity: the rational-Krylov helpers, NLEIGS and the CORK pencils.

The same problems, built in both packages from the same numpy/scipy data,
go through the JAX package and the port (``device="cpu"``, complex128):
the Leja-Bagby nodes, divided differences and polygon helpers elementwise
to 1e-12; NLEIGS eigenvalues to rel 1e-10 (as sets: the two LAPACK calls
may order a spectrum differently) with the ``details`` arrays; the CORK
pencils elementwise to 1e-12.  The gun-structured case (n = 576, a stacked-
DIA bank, ``computeD`` False) puts the DIA apply's plain twin on the
compared path."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import CPU, gallery_pair, small_gun_like

import neptpu
import neptpu_torch as nt

B2 = [np.array([[1.0, 3], [5, 6]]), np.array([[3.0, 4], [6, 6]]), np.eye(2)]
SIGMA = [-10.0 - 2j, 10 - 2j, 10 + 2j, -10 + 2j]
UNIT_SQUARE = [1.0 + 1j, 1.0 - 1j, -1.0 - 1j, -1.0 + 1j]
EXACT = 1e-12
REL = 1e-10


def _close(a, b, tol=EXACT):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(b), initial=0.0)))
    assert np.max(np.abs(a - b), initial=0.0) <= tol * scale


def _same_set(a, b, rel=REL):
    """Every value of each within rel of one of the other, equal counts."""
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), (a, b)
    for x in a:
        assert np.min(np.abs(b - x)) <= rel * abs(x), (x, b)
    for x in b:
        assert np.min(np.abs(a - x)) <= rel * abs(x), (x, a)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def pep2x2():
    return nt.PEP(B2, device=CPU), neptpu.PEP(B2)


# -- helpers ---------------------------------------------------------------
@pytest.mark.parametrize("keepA,forceInf,poles", [
    (False, 0, "inf"), (False, 2, "cut"), (True, 1, "cut")])
def test_lejabagby_matches(keepA, forceInf, poles):
    A = np.exp(2j * np.pi * np.arange(50) / 50) * 3 + 0.5j
    B = (np.array([np.inf]) if poles == "inf"
         else -np.logspace(-2, 3, 200) + 0j)
    out_t = nt.lejabagby(A, B, A, 12, keepA, forceInf)
    out_j = neptpu.lejabagby(A, B, A, 12, keepA, forceInf)
    for x, y in zip(out_t, out_j):
        assert np.array_equal(np.isinf(x), np.isinf(y))
        _close(np.where(np.isinf(x), 0, x), np.where(np.isinf(y), 0, y))


def test_inpolygon_and_discretizepolygon_match():
    sx, sy = [-1.0, 1.0, 1.0, -1.0], [-1.0, -1.0, 1.0, 1.0]
    for p in [(0.0, 0.0), (2.0, 0.0), (1.0, 1.0), (1.0, 0.3), (np.nan, 0)]:
        assert nt.inpolygon(*p, sx, sy) == neptpu.inpolygon(*p, sx, sy)
    for z, interior in [(SIGMA, True), (UNIT_SQUARE, False), ([0.5j], True),
                        ([0.01, 4.0], True)]:
        zt, Zt = nt.discretizepolygon(z, interior, npts=500)
        zj, Zj = neptpu.discretizepolygon(z, interior, npts=500)
        _close(zt, zj)
        _close(Zt, Zj)


def test_divided_differences_match():
    """``evalrat``, ``ratnewtoncoeffs`` (matrix-valued, through each
    package's ``compute_Mder``), ``ratnewtoncoeffsm`` and ``scgendivdiffs``
    (each package's own matrix functions) elementwise."""
    from neptpu.ops import matfun as jm
    from neptpu_torch.ops import matfun as tm

    # a box off the square root's cut, the poles on it
    gamma = nt.discretizepolygon([5 - 2j, 5 + 2j, 15 + 2j, 15 - 2j])[0]
    Xi = -np.logspace(-3, 3, 500)
    sig, xi, beta = nt.lejabagby(gamma, Xi, gamma, 14, False, 0)
    z = np.array([0.3 + 0.2j, -4.0 + 1j])
    from neptpu.solvers.rk import evalrat as jevalrat
    from neptpu_torch.solvers.rk import evalrat as tevalrat

    _close(tevalrat(sig[:5], xi[:5], beta[:6], z),
           jevalrat(sig[:5], xi[:5], beta[:6], z))
    # M(lam) of a delay problem holds exp(-lam): differenced over the
    # first four nodes (see below)
    tnep, jnep = gallery_pair("dep0")
    Dt = nt.ratnewtoncoeffs(
        lambda L: tnep.Mder_dense(complex(L.reshape(-1)[0])), sig[:4], xi,
        beta)
    Dj = neptpu.ratnewtoncoeffs(
        lambda L: jnep.Mder_dense(complex(np.asarray(L).ravel()[0])), sig[:4],
        xi, beta)
    for a, b in zip(Dt, Dj):
        _close(_host(a), np.asarray(b))
    _close(nt.ratnewtoncoeffsm(tm.expm, sig, xi, beta),
           neptpu.ratnewtoncoeffsm(jm.expm, sig, xi, beta))
    # by the matrix function, and by differencing; differencing amplifies
    # the libraries' last-bit differences in the values of an entire
    # function by orders of magnitude (exp and sin: 1e-11 to 1e-9 here), so
    # that branch is compared on the square root, whose differences decay
    _close(nt.scgendivdiffs(sig, xi, beta, 12, True,
                            [tm.expm, tm.sqrtm, tm.eye_like]),
           neptpu.scgendivdiffs(sig, xi, beta, 12, True,
                                [jm.expm, jm.sqrtm, jm.eye_like]))
    _close(nt.scgendivdiffs(sig, xi, beta, 12, False,
                            [tm.sqrtm, tm.eye_like]),
           neptpu.scgendivdiffs(sig, xi, beta, 12, False,
                                [jm.sqrtm, jm.eye_like]))


@pytest.mark.parametrize("leja", [0, 1, 2])
def test_nleigs_coefficients_match(pep2x2, leja):
    tp, jp = pep2x2
    kw = dict(maxdgr=20, tollin=1e-10, leja=leja,
              nodes=[0.5 + 0.1j, -1 + 0.2j] if leja == 0 else ())
    Dt, bt, xt, st = nt.nleigs_coefficients(tp, SIGMA, **kw)
    Dj, bj, xj, sj = neptpu.nleigs_coefficients(jp, SIGMA, **kw)
    assert len(Dt) == len(Dj)
    for a, b in zip(Dt, Dj):
        _close(_host(a), np.asarray(b))
    _close(bt, bj)
    _close(st, sj)
    _close(np.nan_to_num(xt, posinf=0), np.nan_to_num(xj, posinf=0))


def test_rknep_classification_and_weighted_apply():
    """``get_rk_nep`` classifies the port's problems as the JAX package
    classifies its own, and ``apply_weighted`` (one fused apply per term
    bank) equals the JAX loop over the terms."""
    K, M, W1, W2 = small_gun_like()
    from neptpu.models.gallery.nlevp import _gun_from_matrices as jgun
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices as tgun

    tn, jn = tgun(K, M, W1, W2, device=CPU), jgun(K, M, W1, W2)
    Pt, Pj = nt.get_rk_nep(tn), neptpu.get_rk_nep(jn)
    assert (Pt.spmf, Pt.p, Pt.q, Pt.is_low_rank) == (
        Pj.spmf, Pj.p, Pj.q, Pj.is_low_rank) == (True, 1, 2, False)
    assert type(tn.nep1.bank).__name__ == "DiaTermBank"
    rng = np.random.default_rng(4)
    c = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    x = rng.standard_normal(tn.n) + 1j * rng.standard_normal(tn.n)
    yt = Pt.apply_weighted(c, torch.as_tensor(x))
    yj = Pj.apply_weighted(c, jnp.asarray(x))
    _close(_host(yt), np.asarray(yj))


# -- NLEIGS ------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(static=True), dict(leja=0, nodes=[0.5 + 0.1j, -1 + 0.2j]),
    dict(leja=2), dict(return_details=True)],
    ids=["dynamic", "static", "leja0", "leja2", "details"])
def test_nleigs_pep2x2(pep2x2, kw):
    tp, jp = pep2x2
    common = dict(maxit=10, v=np.ones(2) + 0j, blksize=5, maxdgr=20)
    lt, Xt, rt, dt = nt.nleigs(tp, SIGMA, device=CPU, **common, **kw)
    lj, Xj, rj, dj = neptpu.nleigs(jp, SIGMA, **common, **kw)
    assert len(lt) == 4
    _same_set(lt, np.asarray(lj))
    assert isinstance(Xt, torch.Tensor) and Xt.shape == (2, 4)
    for i in range(4):
        assert float(nt.compute_resnorm(tp, lt[i], Xt[:, i])) < 1e-8
    if kw.get("return_details"):
        assert dt.kconv == dj.kconv > 0
        _close(dt.sigma, dj.sigma)
        _close(dt.beta, dj.beta)
        _close(dt.nrmD, dj.nrmD)
        _close(np.nan_to_num(dt.xi, posinf=0), np.nan_to_num(dj.xi, posinf=0))
        assert dt.Lam.shape == dj.Lam.shape and dt.Res.shape == dj.Res.shape


def test_nleigs_nonconvergent_linearization(pep2x2):
    tp, jp = pep2x2
    kw = dict(maxit=10, v=np.ones(2) + 0j, maxdgr=5, blksize=5)
    with pytest.warns(UserWarning, match="Linearization not converged"):
        lt, _, _, _ = nt.nleigs(tp, SIGMA, device=CPU, **kw)
    with pytest.warns(UserWarning, match="Linearization not converged"):
        lj, _, _, _ = neptpu.nleigs(jp, SIGMA, **kw)
    _same_set(lt, np.asarray(lj))


def test_nleigs_dep0():
    tn, jn = gallery_pair("dep0")
    lt, Xt, rt, _ = nt.nleigs(tn, UNIT_SQUARE, v=np.ones(5) + 0j, device=CPU)
    lj, _, _, _ = neptpu.nleigs(jn, UNIT_SQUARE, v=np.ones(5) + 0j)
    assert len(lt) >= 3
    _same_set(lt, np.asarray(lj))
    for i in range(len(lt)):
        assert float(nt.compute_resnorm(tn, lt[i], Xt[:, i])) < 1e-10


@pytest.mark.parametrize("computeD", [True, False])
def test_nleigs_low_rank_tail(computeD):
    """The low-rank branch (``SPMFSumNEP(PEP, LowRankFactorizedNEP)``): the
    r-sized tail blocks, explicit and matrix-free (compacted LL)."""
    eye = [sp.csr_matrix(np.eye(2))]

    def problem(pkg, **dev):
        fsq = ((lambda S: S @ S) if pkg is nt
               else (lambda S: jnp.asarray(S) @ jnp.asarray(S)))
        return pkg.SumNEP(pkg.PEP(B2[:2], **dev), pkg.LowRankFactorizedNEP(
            eye, eye, [fsq], A=[np.eye(2)], **dev))

    tn, jn = problem(nt, device=CPU), problem(neptpu)
    assert nt.get_rk_nep(tn).is_low_rank
    kw = dict(maxit=10, v=np.ones(2) + 0j, blksize=5, computeD=computeD)
    lt, Xt, rt, _ = nt.nleigs(tn, SIGMA, device=CPU, **kw)
    lj, _, _, _ = neptpu.nleigs(jn, SIGMA, **kw)
    assert len(lt) == 4
    _same_set(lt, np.asarray(lj))
    assert np.max(rt) < 1e-6


@pytest.fixture(scope="module")
def small_gun():
    """gun structure at n = 576 with its spectrum scaled past the second
    branch point (K times 4: eigenvalues up to 2e4), so that a box near
    1.5e4 is off both square roots' cuts as gun_like's target is."""
    from neptpu.models.gallery.nlevp import _gun_from_matrices as jgun
    from neptpu_torch.models.gallery.nlevp import (GUN_SIGMA2,
                                                   _gun_from_matrices as tgun)

    K, M, W1, W2 = small_gun_like()
    K = (4 * K).tocsr()
    box = [14900 - 10j, 14900 + 10j, 15060 + 10j, 15060 - 10j]
    return dict(tnep=tgun(K, M, W1, W2, device=CPU), jnep=jgun(K, M, W1, W2),
                box=box, nodes=[14930 + 2j, 15010 + 2j],
                Xi=GUN_SIGMA2**2 - np.logspace(-8, 8, 10000))


def test_nleigs_gun_structured(small_gun):
    g = small_gun
    tn = g["tnep"]
    assert type(tn.nep1.bank).__name__ == "DiaTermBank" and tn.n == 576
    kw = dict(Xi=g["Xi"], nodes=g["nodes"], tol=1e-10)
    stats = {}
    lt, Xt, rt, _ = nt.nleigs(tn, g["box"], errmeasure=(
        nt.StandardSPMFErrmeasure), stats=stats, device=CPU, **kw)
    lj, _, rj, _ = neptpu.nleigs(g["jnep"], g["box"], errmeasure=(
        neptpu.StandardSPMFErrmeasure), **kw)
    assert len(lt) == 6 and stats["kconv"] is not None
    assert stats["D_applies"] >= stats["iterations"] > 0
    _same_set(lt, np.asarray(lj))
    assert np.max(rt) < 1e-10


# -- CORK pencils --------------------------------------------------------------
def _pencil_pair(cp_t, cp_j):
    At, Bt = nt.build_pencil(cp_t, device=CPU)
    Aj, Bj = neptpu.build_pencil(cp_j)
    _close(At.numpy(), np.asarray(Aj))
    _close(Bt.numpy(), np.asarray(Bj))
    return At.numpy(), Bt.numpy()


def test_cork_pencil_iar_and_low_rank_compress():
    import scipy.linalg as sla

    A0 = np.array([[1.0, 3.0], [-1.0, 2.0]]) / 10
    v = np.array([[-1.0], [1.0]]) / np.sqrt(2)
    tn = nt.DEP([A0, v @ v.T], [0.0, 1.0], device=CPU)
    jn = neptpu.DEP([A0, v @ v.T], [0.0, 1.0])
    cpt = nt.CORKPencil.from_nep(tn, nt.IarCorkLinearization(d=10))
    cpj = neptpu.CORKPencil.from_nep(jn, neptpu.IarCorkLinearization(d=10))
    A, B = _pencil_pair(cpt, cpj)
    w = sla.eig(A, B, right=False)
    w = w[np.isfinite(w)]
    cand = w[np.abs(w) < 1.5]
    smins = [np.linalg.svd(_host(tn.Mder_dense(x)), compute_uv=False)[-1]
             for x in cand]
    assert min(smins) < 1e-10
    lam = cand[int(np.argmin(smins))]
    AA, BB = _pencil_pair(nt.low_rank_compress(cpt, 1, 1),
                          neptpu.low_rank_compress(cpj, 1, 1))
    w2 = sla.eig(AA, BB, right=False)
    assert np.min(np.abs(w2[np.isfinite(w2)] - lam)) < 1e-8


def test_cork_pencil_nleigs(pep2x2):
    import scipy.linalg as sla

    tp, jp = pep2x2
    lin = dict(Sigma=SIGMA, maxdgr=20, tollin=1e-10)
    A, B = _pencil_pair(
        nt.CORKPencil.from_nep(tp, nt.NleigsCorkLinearization(**lin)),
        neptpu.CORKPencil.from_nep(jp, neptpu.NleigsCorkLinearization(**lin)))
    w = sla.eig(A, B, right=False)
    w = w[np.isfinite(w)]
    C = np.block([[np.zeros((2, 2)), np.eye(2)], [-B2[0], -B2[1]]])
    for t in np.linalg.eigvals(C):
        assert np.min(np.abs(w - t)) < 1e-7
