"""Port parity: Effenberger deflation (the three modes, one and two levels
deep), the low-rank factor terms, the padded DIA bank and the
Schur-complement solver, against the JAX package on the CPU in complex128.

Tolerance: rel 1e-12 for every compute function - the two packages compute
the same sums in another order (the port keeps the factors L, U where the
JAX package forms L U^H)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.models.deflation import _resolvent_term, normalize_schur_pair
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.ops.sparse import DenseTermBank, SparseTermBank

RTOL = 1e-12
LAM = 0.2 + 0.1j
A3 = np.array([1.0, 0.5, 0.3])


def _pairs(n, seed=0):
    """Two eigenpair-shaped inputs (not eigenpairs: every term of the
    deflated problem then counts) for levels one and two."""
    rng = np.random.default_rng(seed)
    return ((-0.3 + 0.2j, rng.standard_normal(n) + 1j * rng.standard_normal(n)),
            (0.1 - 0.4j,
             rng.standard_normal(n + 1) + 1j * rng.standard_normal(n + 1)))


def _deflate_both(tnep, jnep, mode, seed=0):
    (l1, v1), (l2, v2) = _pairs(tnep.n, seed)
    j1 = neptpu.deflate_eigpair(jnep, l1, v1, mode=mode)
    t1 = neptpu_torch.deflate_eigpair(tnep, l1, torch.from_numpy(v1),
                                      mode=mode)
    j2 = neptpu.deflate_eigpair(j1, l2, v2)
    t2 = neptpu_torch.deflate_eigpair(t1, l2, torch.from_numpy(v2))
    return [(t1, j1), (t2, j2)]


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


@pytest.fixture(scope="module")
def dep0():
    return gallery_pair("dep0")


@pytest.mark.parametrize("mode", [":SPMF", ":Generic", ":MM"])
def test_deflated_compute_functions_match_jax(dep0, mode):
    tnep, jnep = dep0
    rng = np.random.default_rng(3)
    for tnd, jnd in _deflate_both(tnep, jnep, mode):
        N = tnd.n
        assert N == jnd.n and tnd.p == jnd.p
        np.testing.assert_allclose(tnd.S0, jnd.S0, rtol=RTOL, atol=1e-14)
        V = rng.standard_normal((N, 3)) + 1j * rng.standard_normal((N, 3))
        for sd in (0, 1):
            zt = neptpu_torch.compute_Mlincomb(tnd, LAM, torch.from_numpy(V),
                                               A3, startder=sd)
            zj = neptpu.compute_Mlincomb(jnd, LAM, jnp.asarray(V),
                                         jnp.asarray(A3), startder=sd)
            assert rel_err(zt, zj) < RTOL
        for der in (0, 1):
            assert rel_err(_dense(tnd.Mder(LAM, der)),
                           jnd.Mder_dense(LAM, der)) < RTOL
        S = np.array([[0.1 + 0.2j, 0.3], [0.0, -0.2 + 0.1j]])
        W = rng.standard_normal((N, 2)) + 0j
        assert rel_err(neptpu_torch.compute_MM(tnd, torch.from_numpy(S),
                                               torch.from_numpy(W)),
                       neptpu.compute_MM(jnd, jnp.asarray(S),
                                         jnp.asarray(W))) < RTOL


def test_deflated_dep_keeps_its_dia_bank():
    """The padded original terms of a deflated DEP stay a DIA bank with the
    original's offsets (the kernel applies the deflated problem), with the
    -lam I term joined to it; the deflation terms keep their factors."""
    tnep, jnep = gallery_pair("dep_symm_double", 24)
    assert isinstance(tnep.bank, DiaTermBank)
    rng = np.random.default_rng(4)
    for level, (tnd, jnd) in enumerate(_deflate_both(tnep, jnep, ":Auto"),
                                       start=1):
        assert isinstance(tnd, neptpu_torch.DeflatedSPMF)
        bank = tnd.spmf.nep1.bank
        assert isinstance(bank, DiaTermBank)
        assert bank.offsets == tnep.bank.offsets
        assert bank.shape == (tnep.n + level,) * 2
        assert bank.nterms == tnep.bank.nterms + 1
        assert bank.dtype == torch.float64
        assert torch.all(bank.data[..., tnep.n:] == 0)
        lowrank = tnd.spmf.nep2
        assert isinstance(lowrank, neptpu_torch.LowRankFactorizedNEP)
        assert lowrank.r == 3 * level + level
        V = rng.standard_normal((tnd.n, 2)) + 1j * rng.standard_normal(
            (tnd.n, 2))
        for sd in (0, 1):
            zt = neptpu_torch.compute_Mlincomb(tnd, -1.0 + 0.01j,
                                               torch.from_numpy(V),
                                               A3[:2], startder=sd)
            zj = neptpu.compute_Mlincomb(jnd, -1.0 + 0.01j, jnp.asarray(V),
                                         jnp.asarray(A3[:2]), startder=sd)
            assert rel_err(zt, zj) < RTOL
        # the backward error over the deflated terms' Frobenius norms (the
        # factor terms' from their Gram matrices)
        et = neptpu_torch.StandardSPMFErrmeasure(tnd)(-1.0,
                                                     torch.from_numpy(V[:, 0]))
        ej = float(neptpu.StandardSPMFErrmeasure(jnd)(-1.0,
                                                      jnp.asarray(V[:, 0])))
        assert abs(et - ej) < RTOL * ej


@pytest.mark.parametrize("name,args,kind", [("pep0", (8,), DenseTermBank),
                                            ("pep0_sparse", (8,),
                                             SparseTermBank)])
def test_deflated_pep_pads_its_bank_in_its_own_form(name, args, kind):
    tnep, jnep = gallery_pair(name, *args)
    assert isinstance(tnep.bank, kind)
    rng = np.random.default_rng(5)
    for tnd, jnd in _deflate_both(tnep, jnep, ":SPMF"):
        assert isinstance(tnd.spmf.nep1.bank, kind)
        assert tnd.spmf.nep1.bank.nterms == tnep.bank.nterms
        V = rng.standard_normal((tnd.n, 3)) + 1j * rng.standard_normal(
            (tnd.n, 3))
        zt = neptpu_torch.compute_Mlincomb(tnd, LAM, torch.from_numpy(V), A3)
        zj = neptpu.compute_Mlincomb(jnd, LAM, jnp.asarray(V), jnp.asarray(A3))
        assert rel_err(zt, zj) < RTOL
        assert rel_err(tnd.Mder_dense(LAM), jnd.Mder_dense(LAM)) < RTOL


def test_deflated_sum_pads_each_part_in_its_own_form():
    """A sum of SPMFs (the gun structure: a PEP on a DIA bank plus sqrt
    terms on CSR boundary matrices) is padded part by part."""
    from torch_port_helpers import small_gun_like

    from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices

    ops = small_gun_like(nx=24)
    tnep, jnep = _gun_from_matrices(*ops, device=CPU), jax_gun(*ops)
    rng = np.random.default_rng(12)
    for tnd, jnd in _deflate_both(tnep, jnep, ":SPMF"):
        padded = tnd.spmf.nep1
        assert isinstance(padded, neptpu_torch.SPMFSumNEP)
        assert type(padded.nep1.bank) is type(tnep.nep1.bank)
        assert type(padded.nep2.bank) is type(tnep.nep2.bank)
        V = rng.standard_normal((tnd.n, 2)) + 1j * rng.standard_normal(
            (tnd.n, 2))
        lam = 1250.0 + 5.0j
        assert rel_err(neptpu_torch.compute_Mlincomb(tnd, lam,
                                                     torch.from_numpy(V)),
                       neptpu.compute_Mlincomb(jnd, lam,
                                               jnp.asarray(V))) < RTOL


def test_get_deflated_eigpairs_matches_jax(dep0):
    tnep, jnep = dep0
    (tnd, jnd), (tnd2, jnd2) = _deflate_both(tnep, jnep, ":SPMF")
    v = np.random.default_rng(6).standard_normal(tnd2.n) + 0j
    for args in ((), (0.7 + 0.1j, v)):
        targs = args if not args else (args[0], torch.from_numpy(args[1]))
        Dt, Vt = neptpu_torch.get_deflated_eigpairs(tnd2, *targs)
        Dj, Vj = neptpu.get_deflated_eigpairs(jnd2, *args)
        order_t, order_j = np.argsort(Dt.real), np.argsort(np.asarray(Dj).real)
        assert rel_err(Dt[order_t], np.asarray(Dj)[order_j]) < RTOL
        assert isinstance(Vt, torch.Tensor) and Vt.shape == (tnep.n,
                                                             len(Dt))
        # eigenvectors up to a scale each: compare the normalized columns
        for it, ij in zip(order_t, order_j):
            a = Vt[:, it].numpy()
            b = np.asarray(Vj)[:, ij]
            assert abs(abs(np.vdot(a, b)) - np.linalg.norm(a)
                       * np.linalg.norm(b)) < 1e-10 * np.linalg.norm(a) ** 2


def test_deflated_linsolver_matches_jax(dep0):
    """The Schur-complement solve: the first solve (p+1 columns in one block)
    and the second (the kept Z and Schur complement) against the JAX
    package's and against the bordered matrix."""
    tnep, jnep = dep0
    for tnd, jnd in _deflate_both(tnep, jnep, ":Generic"):
        ts = neptpu_torch.create_linsolver(
            neptpu_torch.DeflatedNEPLinSolverCreator(), tnd, 0.4)
        js = neptpu.create_linsolver(neptpu.DeflatedNEPLinSolverCreator(),
                                     jnd, 0.4)
        assert isinstance(ts, neptpu_torch.DeflatedNEPLinSolver)
        rng = np.random.default_rng(7)
        M = tnd.Mder(0.4).numpy()
        for _ in range(2):
            b = rng.standard_normal(tnd.n) + 1j * rng.standard_normal(tnd.n)
            xt = neptpu_torch.lin_solve(ts, torch.from_numpy(b))
            xj = neptpu.lin_solve(js, jnp.asarray(b))
            assert rel_err(xt, xj) < 1e-10
            assert rel_err(M @ xt.numpy(), b) < 1e-10


def test_resolvent_term_on_1x1_matches_the_jax_scalar_form(dep0):
    """The port evaluates term functions on 1 x 1 matrices (the matrix
    branch); the JAX package's scalar branch gives the same value."""
    tnep, jnep = dep0
    (tnd, jnd), _ = _deflate_both(tnep, jnep, ":SPMF")
    tfv = tnd.spmf.nep2.get_fv()
    jfv = jnd.spmf.nep2.get_fv()
    assert len(tfv) == len(jfv) == 3 + 1
    for lam in (0.3 + 0.2j, -1.5 + 0.0j):
        S = torch.tensor([[lam]], dtype=torch.complex128)
        for ft, fj in zip(tfv[:-1], jfv[:-1]):
            a = complex(ft(S)[0, 0])
            b = complex(np.asarray(fj(jnp.asarray(lam))))
            assert abs(a - b) <= RTOL * abs(b)
            # the 0-dim form of the port's function is the scalar branch
            assert abs(complex(ft(S[0, 0])) - b) <= RTOL * abs(b)
    f = _resolvent_term(lambda S: -S, 0.5)
    S2 = torch.tensor([[0.2 + 0.1j, 0.3], [0.0, -0.4j]], dtype=torch.complex128)
    assert rel_err(f(S2), np.linalg.solve(S2.numpy() - 0.5 * np.eye(2),
                                          -S2.numpy())) < RTOL
    # at the deflated eigenvalue itself: non-finite, as in the JAX package
    at = f(torch.tensor([[0.5 + 0j]]))
    assert not torch.isfinite(at).all()
    assert not np.isfinite(np.asarray(jfv[0](jnp.asarray([[complex(
        jnd.S0[0, 0])]])))).all()


def test_normalize_schur_pair_matches_jax():
    from neptpu.models.deflation import normalize_schur_pair as jnorm

    rng = np.random.default_rng(8)
    S = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    V = rng.standard_normal((10, 3)) + 1j * rng.standard_normal((10, 3))
    St, Vt = normalize_schur_pair(S, V)
    Sj, Vj = jnorm(S, V)
    assert rel_err(St, Sj) < RTOL and rel_err(Vt, Vj) < RTOL
    with pytest.warns(UserWarning, match="short and skinny"):
        normalize_schur_pair(S, V[:2])


def test_lowrank_factorized_nep_matches_jax():
    """Factor storage against the JAX package's dense ``L U^H`` terms:
    compute functions, the term objects and the Frobenius norms."""
    from neptpu.models.lowrank import LowRankFactorizedNEP as JLR
    from neptpu.ops import matfun as jmf

    from neptpu_torch.ops import matfun as tmf

    rng = np.random.default_rng(9)
    n, ranks = 30, (1, 2, 3)
    L = [rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r))
         for r in ranks]
    U = [rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r))
         for r in ranks]
    tfv = [tmf.eye_like, lambda S: -S, tmf.expm]
    jfv = [jmf.eye_like, lambda S: -S, jmf.expm]
    t = neptpu_torch.LowRankFactorizedNEP(L, U, tfv, device=CPU)
    j = JLR(L, U, jfv)
    assert t.r == j.r == 6
    V = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    for sd in (0, 2):
        assert rel_err(neptpu_torch.compute_Mlincomb(t, LAM,
                                                     torch.from_numpy(V), A3,
                                                     startder=sd),
                       neptpu.compute_Mlincomb(j, LAM, jnp.asarray(V),
                                               jnp.asarray(A3),
                                               startder=sd)) < RTOL
    assert rel_err(_dense(t.Mder(LAM, 1)), j.Mder_dense(LAM, 1)) < RTOL
    S = np.array([[0.1 + 0.2j, 0.3], [0.0, -0.2 + 0.1j]])
    assert rel_err(t.MM(torch.from_numpy(S), torch.from_numpy(V[:, :2])),
                   j.MM(jnp.asarray(S), jnp.asarray(V[:, :2]))) < RTOL
    terms = t.get_Av()
    x = torch.from_numpy(V[:, 0])
    for i, (Lt, Ut) in enumerate(zip(L, U)):
        dense = Lt @ Ut.conj().T
        assert rel_err(terms[i].to_dense(), dense) < RTOL
        assert rel_err(terms[i] @ x, dense @ V[:, 0]) < RTOL
        assert abs(float(t.bank.fro_norms[i]) - np.linalg.norm(dense)) < (
            RTOL * np.linalg.norm(dense))
    amf = [neptpu_torch.LowRankMatrixAndFunction(None, f, L=Li, U=Ui)
           for f, Li, Ui in zip(tfv, L, U)]
    t2 = neptpu_torch.LowRankFactorizedNEP.from_amf(amf, device=CPU)
    assert rel_err(t2.Mlincomb(LAM, torch.from_numpy(V)),
                   t.Mlincomb(LAM, torch.from_numpy(V))) < RTOL
    # a sparse term is compacted to its factors on construction
    import scipy.sparse as sp

    A = sp.random(n, n, density=0.01, random_state=1, format="csr")
    m = neptpu_torch.LowRankMatrixAndFunction(A, tmf.eye_like)
    assert rel_err(m.L @ m.U.conj().T, A.toarray()) < RTOL


def test_deflated_nep_needs_an_spmf_for_spmf_mode(dep0):
    tnep, _ = dep0
    generic = neptpu_torch.GenericSumNEP(tnep, tnep)
    with pytest.raises(ValueError, match="SPMF-mode"):
        neptpu_torch.deflate_eigpair(generic, 0.1, torch.ones(tnep.n),
                                     mode=":SPMF")
    d = neptpu_torch.deflate_eigpair(generic, 0.1, torch.ones(tnep.n))
    assert isinstance(d, neptpu_torch.DeflatedGenericNEP)
    assert isinstance(d, neptpu_torch.DeflatedNEP)
    with pytest.raises(ValueError, match="unknown deflation mode"):
        neptpu_torch.deflate_eigpair(tnep, 0.1, torch.ones(tnep.n),
                                     mode=":Nope")


@pytest.mark.parametrize("mode", [":SPMF", ":Generic"])
def test_interop_starts_the_port_from_the_jax_mid_run_state(mode):
    """A deflated NEP from the JAX one's (S0, V0) over the port's copy of the
    original's bank, and its projection from the JAX projection's (W, V):
    the same compute functions."""
    from torch_port_helpers import to_spec

    from neptpu_torch.interop import (dep_from_arrays, deflated_from_arrays,
                                      proj_from_arrays)

    jnep = neptpu.nep_gallery("dep_symm_double", 24)
    tnep = dep_from_arrays(to_spec(jnep.bank), np.asarray(jnep.tauv),
                           device=CPU)
    _, (tnd_own, jnd) = _deflate_both(
        neptpu_torch.nep_gallery("dep_symm_double", 24, device=CPU), jnep,
        mode)
    tnd = deflated_from_arrays(tnep, jnd.S0, jnd.V0, mode)
    assert isinstance(tnd, type(tnd_own)) and tnd.p == 2
    V = np.random.default_rng(10).standard_normal((tnd.n, 2)) + 0j
    assert rel_err(neptpu_torch.compute_Mlincomb(tnd, -1.0, torch.from_numpy(V)),
                   neptpu.compute_Mlincomb(jnd, -1.0, jnp.asarray(V))) < RTOL
    if mode == ":SPMF":
        rng = np.random.default_rng(11)
        W, Vb = (np.linalg.qr(rng.standard_normal((tnd.n, 3)))[0] + 0j
                 for _ in range(2))
        jp = neptpu.create_proj_NEP(jnd, 5)
        jp.set_projectmatrices(W, Vb)
        tp = proj_from_arrays(tnd, jp.W, jp.V, 5)
        assert rel_err(tp.Mder_dense(-1.0), jp.Mder_dense(-1.0)) < RTOL
