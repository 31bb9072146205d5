"""Port parity: ``DerSPMF``, the function-handle problems (``Mder_NEP``,
``Mder_Mlincomb_NEP``, ``REP``), ``interpolate_pep``, the transformations
(``shift_and_scale``, ``mobius_transform``, ``taylor_expansion_pep`` on a
DEP, a PEP and an SPMF) and the matrix functions ``inv``, ``sinm``,
``cosm``, ``sinhm``, ``coshm``, against the JAX package on the CPU in
complex128 on the same numpy inputs.

Tolerance: rel 1e-12 (the same sums in another order; the interpolation's
Vandermonde solve and the composed matrix functions through the derivative
trick to 1e-10)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu.ops import matfun as jmf
from neptpu_torch.ops import matfun as tmf
from neptpu_torch.ops.dia import DiaTermBank

LAM = 0.3 - 0.2j


def _V(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))


def _mats(n, count, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)) for _ in range(count)]


def _mlincombs_agree(tnep, jnep, n, lam=LAM, k=3, startder=0, rtol=1e-12):
    V = _V(n, k)
    a = np.array([1.0, 0.5, -0.25, 2.0][:k])
    zt = neptpu_torch.compute_Mlincomb(tnep, lam, torch.from_numpy(V), a,
                                       startder=startder)
    zj = neptpu.compute_Mlincomb(jnep, lam, jnp.asarray(V), jnp.asarray(a),
                                 startder=startder)
    assert rel_err(zt.numpy(), np.asarray(zj)) < rtol


def _mders_agree(tnep, jnep, lam=LAM, ders=(0, 1, 2), rtol=1e-12):
    for d in ders:
        Mt = neptpu_torch.compute_Mder(tnep, lam, d)
        Mt = Mt if isinstance(Mt, torch.Tensor) else Mt.to_dense()
        Mj = neptpu.compute_Mder(jnep, lam, d)
        Mj = Mj if isinstance(Mj, jnp.ndarray) else Mj.to_dense()
        assert rel_err(Mt.numpy(), np.asarray(Mj)) < rtol, d


def _spmf_pair(n=6):
    """An SPMF with -S, expm(-S) and sinm(S) terms, in both packages."""
    A = _mats(n, 3)
    jnep = neptpu.SPMF_NEP(A, [lambda S: -jnp.asarray(S),
                               lambda S: jmf.expm(-jnp.asarray(S)),
                               jmf.sinm])
    tnep = neptpu_torch.SPMF_NEP(A, [lambda S: -S,
                                     lambda S: tmf.expm(-S), tmf.sinm],
                                 device=CPU)
    return tnep, jnep


@pytest.mark.parametrize("name", ["inv", "sinm", "cosm", "sinhm", "coshm"])
def test_matfun_matches_jax(name):
    rng = np.random.default_rng(3)
    for S in (rng.standard_normal((4, 4)),
              rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)),
              tmf.jordan_matrix(0.4 - 0.1j, 5).numpy()):
        out = getattr(tmf, name)(torch.from_numpy(S))
        ref = np.array(getattr(jmf, name)(jnp.asarray(S)))
        assert out.dtype == torch.from_numpy(ref).dtype
        assert rel_err(out.numpy(), ref) < 1e-12
    z = 0.3 - 0.2j
    zt = torch.tensor(z, dtype=torch.complex128)
    assert abs(complex(getattr(tmf, name)(zt))
               - complex(getattr(jmf, name)(jnp.asarray(z)))) < 1e-14


def test_derspmf_matches_jax():
    tnep0, jnep0 = _spmf_pair()
    sigma, m = 0.2 + 0.1j, 4
    tnep = neptpu_torch.DerSPMF(tnep0, sigma, m)
    jnep = neptpu.DerSPMF(jnep0, sigma, m)
    assert rel_err(tnep.fD.numpy(), np.asarray(jnep.fD)) < 1e-12
    for lam, sd in ((sigma, 0), (sigma, 1), (LAM, 0)):  # table, fallbacks
        _mlincombs_agree(tnep, jnep, 6, lam=lam, startder=sd)
    _mders_agree(tnep, jnep)
    # the table path equals the problem's own Mlincomb
    V = torch.from_numpy(_V(6, 3))
    assert rel_err(tnep.Mlincomb(sigma, V).numpy(),
                   tnep0.Mlincomb(sigma, V).numpy()) < 1e-12


def _quadratic(n=5):
    A = _mats(n, 3, seed=4)

    def mder(lam, der):
        return [A[0] + lam * A[1] + lam ** 2 * A[2], A[1] + 2 * lam * A[2],
                2 * A[2]][der] if der <= 2 else np.zeros((n, n))

    def mlincomb(lam, V, a, startder):
        V, a = np.asarray(V), np.asarray(a)
        return sum(a[j] * (mder(lam, j + startder) @ V[:, j])
                   for j in range(V.shape[1]))

    return A, mder, mlincomb


def test_function_handle_problems_match_jax():
    A, mder, mlincomb = _quadratic()
    t = neptpu_torch.Mder_NEP(5, mder)
    j = neptpu.Mder_NEP(5, mder)
    _mders_agree(t, j)
    _mlincombs_agree(t, j, 5, startder=1)
    with pytest.raises(ValueError, match="maxder"):
        neptpu_torch.Mder_NEP(5, mder, maxder=1).Mder(LAM, 2)
    t = neptpu_torch.Mder_Mlincomb_NEP(5, mder, mlincomb, maxder_lincomb=1)
    j = neptpu.Mder_Mlincomb_NEP(5, mder, mlincomb, maxder_lincomb=1)
    for k in (2, 3):  # the callback, then past maxder_lincomb the fallback
        _mlincombs_agree(t, j, 5, k=k)


def test_rep_matches_jax():
    A0, A1 = _mats(5, 2, seed=6)
    roots, poles = [1.0, 2.0 + 0.5j], [3.0]
    t = neptpu_torch.REP([A0, A1], roots, poles, device=CPU)
    j = neptpu.REP([A0, A1], roots, poles)
    _mders_agree(t, j)
    _mlincombs_agree(t, j, 5, k=4)


def test_interpolate_pep_matches_jax():
    tnep, jnep = gallery_pair("dep0")
    pts = [0.0, 0.5, -0.5, 1.0]
    t = neptpu_torch.interpolate(tnep, pts)
    j = neptpu.interpolate(jnep, pts)
    assert neptpu_torch.interpolate is neptpu_torch.interpolate_pep
    assert isinstance(t, neptpu_torch.PEP) and t.degree == 3
    assert t.bank.device.type == "cpu"
    _mders_agree(t, j, rtol=1e-10)
    # it interpolates: M(lam_j) exactly at the points
    for p in pts:
        assert rel_err(t.Mder_dense(p).numpy(),
                       tnep.Mder_dense(p).numpy()) < 1e-10


def _problems():
    """A dense DEP, a banded DEP in a DIA bank, a PEP and an SPMF."""
    dep0 = gallery_pair("dep0")
    mats = neptpu_torch.nep_gallery(
        "dep_symm_double", 8, device=CPU).bank.host_csr_terms()
    tau = [0.0, 2.0]
    dia = (neptpu_torch.DEP(None, tauv=tau, bank=DiaTermBank.from_matrices(
        mats, device=CPU)), neptpu.DEP(mats, tau))
    return {"dep": dep0, "dep_dia": dia, "pep": gallery_pair("pep0", 8),
            "spmf": _spmf_pair()}


@pytest.mark.parametrize("kind", ["dep", "dep_dia", "pep", "spmf"])
def test_shift_and_scale_matches_jax(kind):
    tnep, jnep = _problems()[kind]
    shift, scale = -0.3, 1.7
    t = neptpu_torch.shift_and_scale(tnep, shift=shift, scale=scale)
    j = neptpu.shift_and_scale(jnep, shift=shift, scale=scale)
    assert type(t).__name__ == type(j).__name__  # the type is kept
    if kind == "dep_dia":  # and the storage: a DIA bank, one more term
        assert isinstance(t.bank, DiaTermBank) and t.bank.nterms == 3
    _mders_agree(t, j, rtol=1e-10 if kind == "spmf" else 1e-12)
    _mlincombs_agree(t, j, tnep.n, rtol=1e-10 if kind == "spmf" else 1e-12)
    # T(lam) = M(scale lam + shift) (a DEP's divided by the scale)
    mu = 0.2 + 0.1j
    M = tnep.Mder_dense(scale * mu + shift).numpy()
    T = t.Mder_dense(mu).numpy() * (scale if "dep" in kind else 1.0)
    assert rel_err(T, M) < 1e-10


@pytest.mark.parametrize("kind", ["dep", "spmf"])
def test_mobius_transform_matches_jax(kind):
    tnep, jnep = _problems()[kind]
    coef = dict(a=1.0, b=0.2, c=0.3, d=1.1)
    t = neptpu_torch.mobius_transform(tnep, **coef)
    j = neptpu.mobius_transform(jnep, **coef)
    assert type(t).__name__ == type(j).__name__
    _mders_agree(t, j, ders=(0, 1), rtol=1e-10)
    _mlincombs_agree(t, j, tnep.n, k=2, rtol=1e-10)


def test_generic_wrappers_match_jax():
    """A problem of no special type gets the wrapper classes."""
    A, mder, _ = _quadratic()
    t = neptpu_torch.shift_and_scale(neptpu_torch.Mder_NEP(5, mder),
                                     shift=0.4, scale=2.0)
    j = neptpu.shift_and_scale(neptpu.Mder_NEP(5, mder), shift=0.4,
                               scale=2.0)
    assert isinstance(t, neptpu_torch.ShiftScaledNEP)
    _mders_agree(t, j)
    _mlincombs_agree(t, j, 5, startder=1)


@pytest.mark.parametrize("kind", ["dep", "pep"])
def test_taylor_expansion_pep_matches_jax(kind):
    tnep, jnep = _problems()[kind]
    t = neptpu_torch.taylor_expansion_pep(tnep, 3)
    j = neptpu.taylor_expansion_pep(jnep, 3)
    assert isinstance(t, neptpu_torch.PEP) and t.degree == 3
    _mders_agree(t, j, lam=0.1)
