"""Port parity: svAAA and AAAeigs (the compact CORK pencil, the two-level
rational Krylov) on the loaded string, a dense PEP + SPMF sum and a
gun-structured problem at n = 576 (stacked-DIA bank), in complex128 on the
CPU.  The barycentric weights are fixed only up to a phase, so the
approximations are compared through ``reval`` at the samples (to 1e-10),
and the eigenvalues as sets (rel 1e-10)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, gallery_pair, small_gun_like

import neptpu
import neptpu_torch as nt
from neptpu.solvers.aaa import reval as jreval
from neptpu_torch.solvers.aaa import get_prz, reval

REL = 1e-10


def _same_set(a, b, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), (a, b)
    for x in a:
        assert np.min(np.abs(b - x)) <= rel * abs(x), (x, b)
    for x in b:
        assert np.min(np.abs(a - x)) <= rel * abs(x), (x, a)


def _smin(nep, lam):
    M = nep.Mder_dense(lam)
    M = M.cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    return np.linalg.svd(M, compute_uv=False)[-1]


@pytest.mark.parametrize("weighted", [False, True])
def test_svaaa_loaded_string(weighted):
    tn, jn = gallery_pair("nlevp_native_loaded_string")
    Z = np.linspace(0.01, 50, 300) + 0j
    zt, fzt, wt, errt, *_ = nt.svAAA(tn, Z, weighted=weighted)
    zj, fzj, wj, errj, *_ = neptpu.svAAA(jn, Z, weighted=weighted)
    assert len(zt) == len(zj) and errt[-1] < 1e-10
    np.testing.assert_allclose(errt, errj, rtol=1e-6, atol=1e-15)
    pts = np.concatenate([Z, [5.3 + 0.2j, 17.2 - 1j]])
    Rt, Rj = reval(pts, zt, fzt, wt), jreval(pts, zj, fzj, wj)
    assert np.max(np.abs(Rt - Rj)) <= REL * np.max(np.abs(Rj))
    # the interpolant reproduces each term function at a sample
    from neptpu_torch.models.spmf import fun_scalar

    for j, f in enumerate(tn.get_fv()):
        assert abs(Rt[60, j] - complex(fun_scalar(f, Z[60]))) < 1e-8


def test_get_prz_matches():
    tn, jn = gallery_pair("nlevp_native_loaded_string")
    Z = np.linspace(0.01, 50, 300) + 0j
    z, fz, w, *_ = nt.svAAA(tn, Z)
    pt, rt, zt = get_prz(z, fz, w)
    pj, rj, zj = neptpu.solvers.aaa.get_prz(z, fz, w)
    _same_set(pt, pj)
    for i in range(fz.shape[1]):
        fin_t, fin_j = zt[:, i][np.isfinite(zt[:, i])], zj[:, i][
            np.isfinite(zj[:, i])]
        _same_set(fin_t, fin_j, rel=1e-8)
    np.testing.assert_allclose(rt, rj, rtol=1e-8, atol=1e-12)


def test_aaaeigs_loaded_string():
    tn, jn = gallery_pair("nlevp_native_loaded_string", 20, 1.0, 1.0)
    Z = np.linspace(0.01, 50, 400) + 0j
    kw = dict(neigs=3, shifts=[4.0 + 0j, 20.0 + 0j], maxit=40,
              check_error_every=5)
    lt, Xt, rt, _ = nt.AAAeigs(tn, Z, device=CPU, **kw)
    lj, _, _, _ = neptpu.AAAeigs(jn, Z, **kw)
    assert len(lt) == 3 and isinstance(Xt, torch.Tensor)
    _same_set(lt, np.asarray(lj))
    assert np.all(rt < 1e-6)
    for x in lt:
        assert _smin(tn, x) < 1e-10


def test_aaaeigs_pep_plus_spmf_with_details():
    """The general compact pencil (polynomial + nonlinear part), with
    ``return_details``."""
    rng = np.random.default_rng(0)
    n = 30
    P = [rng.standard_normal((n, n)), rng.standard_normal((n, n))]
    S = rng.standard_normal((n, n)) / 5
    tn = nt.SumNEP(nt.PEP(P, device=CPU),
                   nt.SPMF_NEP([S], [nt.matfun.expm], device=CPU))
    jn = neptpu.SumNEP(neptpu.PEP(P),
                       neptpu.SPMF_NEP([S], [neptpu.matfun.expm]))
    Z = 2.0 * np.exp(1j * np.linspace(0, 2 * np.pi, 300, endpoint=False))
    kw = dict(neigs=3, shifts=[0.0 + 0j], maxit=40, check_error_every=5,
              return_details=True)
    lt, _, _, dt = nt.AAAeigs(tn, Z, device=CPU, **kw)
    lj, _, _, dj = neptpu.AAAeigs(jn, Z, **kw)
    _same_set(lt, np.asarray(lj))
    for x in lt:
        assert _smin(tn, x) < 1e-10
    # the approximation's poles lie far out (exp is entire) where they are
    # ill-determined: the details are compared through the interpolant
    assert dt["m_appr"] == dj["m_appr"] and len(dt["pol"]) == len(dj["pol"])
    Rt = reval(Z, dt["z"], dt["fz"], dt["w"])
    Rj = jreval(Z, dj["z"], dj["fz"], dj["w"])
    assert np.max(np.abs(Rt - Rj)) <= REL * np.max(np.abs(Rj))


def _sqrt_term(pkg, c):
    """i sqrt(S - c I); a 1 x 1 argument takes the scalar square root (the
    matrix square root's iteration costs the JAX package a compilation per
    call there)."""
    if pkg is nt:
        from neptpu_torch.ops import matfun as tm

        def f(S):
            S = S - c * tm.eye_like(S)
            return 1j * (torch.sqrt(S) if S.shape[-1] == 1 else tm.sqrtm(S))
        return f
    from neptpu.ops import matfun as jm

    def g(S):
        S = jnp.asarray(S) - c * jm.eye_like(jnp.asarray(S))
        return 1j * (jnp.sqrt(S) if S.shape[-1] == 1 else jm.sqrtm(S))
    return g


@pytest.fixture(scope="module")
def small_gun():
    """The gun structure at n = 576 (K times 4: a spectrum past the second
    branch point, as gun_like's target is), both packages' problems."""
    from neptpu_torch.models.gallery.nlevp import GUN_SIGMA2

    K, M, W1, W2 = small_gun_like()
    K = (4 * K).tocsr()
    c = GUN_SIGMA2**2
    tn = nt.SumNEP(nt.PEP([K, -M], device=CPU), nt.SPMF_NEP(
        [W1, W2], [_sqrt_term(nt, 0.0), _sqrt_term(nt, c)], device=CPU))
    jn = neptpu.SumNEP(neptpu.PEP([K, -M]), neptpu.SPMF_NEP(
        [W1, W2], [_sqrt_term(neptpu, 0.0), _sqrt_term(neptpu, c)]))
    re = np.linspace(14900, 15060, 41)
    im = np.linspace(-10, 10, 11)
    Z = (re[None, :] + 1j * im[:, None]).ravel()
    return tn, jn, Z, [14930 + 2j, 15010 + 2j]


def test_aaaeigs_gun_structured(small_gun):
    tn, jn, Z, nodes = small_gun
    assert type(tn.nep1.bank).__name__ == "DiaTermBank"
    kw = dict(neigs=6, shifts=nodes, tol=1e-10)
    stats = {}
    lt, Xt, rt, _ = nt.AAAeigs(tn, Z, errmeasure=nt.StandardSPMFErrmeasure,
                               stats=stats, device=CPU, **kw)
    lj, _, _, _ = neptpu.AAAeigs(jn, Z, errmeasure=(
        neptpu.StandardSPMFErrmeasure), **kw)
    assert len(lt) == 6 and np.max(rt) < 1e-10
    _same_set(lt, np.asarray(lj))
    assert stats["iterations"] > 0 and stats["m"] > 0


class _Spy:
    """A bank that counts its fused applies."""

    def __init__(self, bank):
        self.bank, self.calls = bank, 0

    def __getattr__(self, name):
        attr = getattr(self.bank, name)
        if not name.startswith("lincomb_apply"):
            return attr

        def counted(*args):
            self.calls += 1
            return attr(*args)
        return counted


def test_operator_apply_is_one_fused_apply_per_bank(small_gun):
    """``sum_i P_i W[:, i]`` over the pencil's operators: one apply of the
    polynomial part's DIA bank and one of the square roots' CSR bank, equal
    to the sum over the terms one by one."""
    from neptpu_torch.solvers.aaa import _operator_apply

    tn = small_gun[0]
    pep, spmf = tn.nep1, tn.nep2
    pep.bank, spmf.bank = _Spy(pep.bank), _Spy(spmf.bank)
    try:
        apply = _operator_apply(tn, pep, spmf, [0, 1])
        rng = np.random.default_rng(2)
        W = torch.as_tensor(rng.standard_normal((tn.n, 4))
                            + 1j * rng.standard_normal((tn.n, 4)))
        y = apply(W)
        assert pep.bank.calls == 1 and spmf.bank.calls == 1
        terms = pep.get_Av() + spmf.get_Av()
        ref = sum(A.matvec(W[:, i]) for i, A in enumerate(terms))
        assert float(torch.linalg.vector_norm(y - ref)
                     / torch.linalg.vector_norm(ref)) < 1e-13
    finally:
        pep.bank, spmf.bank = pep.bank.bank, spmf.bank.bank
