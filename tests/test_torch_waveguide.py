"""Port parity: the waveguide (WEP) gallery problem in its SPMF form and its
mixed term bank, against the JAX package, on the CPU in float64/complex128.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, rel_err

import neptpu
import neptpu_torch
from neptpu.models.gallery import waveguide as jwg
from neptpu.ops.mixed import make_mixed_bank as jax_make_mixed_bank
from neptpu.solvers.spmf_real import collect_spmf_terms as jax_collect
from neptpu_torch.models.gallery import waveguide as twg
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.solvers.spmf_real import collect_spmf_terms

CASES = {"tausch": dict(nx=11, nz=9, benchmark_problem="TAUSCH"),
         "jarlebring": dict(nx=29, nz=21, benchmark_problem="JARLEBRING")}
LAMS = (-1.3 - 0.31j, -3.0 - 3.5j, -0.8 + 2.0j)


@pytest.fixture(scope="module", params=sorted(CASES))
def weps(request):
    kw = CASES[request.param]
    tnep = neptpu_torch.nep_gallery("waveguide", neptype="SPMF", device=CPU,
                                    **kw)
    jnep = neptpu.nep_gallery("waveguide", neptype="SPMF", **kw)
    return tnep, jnep, kw["nz"]


def test_terms_match_jax(weps):
    """The same host assembly: every term matrix agrees to 1e-14 (absolute,
    entries are O(1e3) at most and come from identical numpy/scipy calls),
    and the branch-cut functions carry the same derivative tables."""
    tnep, jnep, nz = weps
    mats, fv = collect_spmf_terms(tnep)
    jmats, jfv = jax_collect(jnep)
    assert len(mats) == len(jmats) == len(fv) == len(jfv) == 3 + 2 * nz
    for A, B in zip(mats, jmats):
        assert A.shape == B.shape
        assert abs(A - B).max() <= 1e-14
    for i in (0, 1, 2, 3, len(fv) // 2, len(fv) - 1):
        np.testing.assert_allclose(fv[i].derivs(LAMS[1], 8),
                                   jfv[i].derivs(LAMS[1], 8), rtol=1e-14)


# complex128 on both sides; the branch-cut terms go through the Schur square
# root of bidiagonal matrices in both packages (rel 1e-12)
@pytest.mark.parametrize("lam", LAMS)
def test_mder_and_mlincomb_match_jax(weps, lam):
    tnep, jnep, _ = weps
    for der in (0, 1):
        M = tnep.Mder_dense(lam, der).numpy()
        J = np.asarray(jnep.Mder_dense(lam, der))
        assert rel_err(M, J) < 1e-12
    rng = np.random.default_rng(41)
    V = (rng.standard_normal((tnep.n, 3))
         + 1j * rng.standard_normal((tnep.n, 3)))
    a = np.array([1.0, 0.5, -0.2])
    y = neptpu_torch.compute_Mlincomb(tnep, lam, torch.from_numpy(V),
                                      a=torch.from_numpy(a)).numpy()
    yj = np.asarray(neptpu.compute_Mlincomb(jnep, lam, jnp.asarray(V),
                                            a=jnp.asarray(a)))
    assert rel_err(y, yj) < 1e-12


def test_branch_cut_square_roots_match_jax():
    """``sqrt_derivative`` (Gegenbauer recurrence) and the Schur square root
    on the positive-imaginary branch: identical host arithmetic (1e-13)."""
    a, b, c, x = 1.0, 2.0 + 1j, 5.0 - 0.3j, 0.7 + 0.2j
    np.testing.assert_allclose(twg.sqrt_derivative(a, b, c, 12, x),
                               jwg.sqrt_derivative(a, b, c, 12, x),
                               rtol=1e-13)
    rng = np.random.default_rng(42)
    A = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    R = twg.sqrt_schur_pos_imag(A)
    assert rel_err(R, jwg.sqrt_schur_pos_imag(A)) < 1e-13
    assert rel_err(R @ R, A) < 1e-12  # and it is a square root
    for z in (2.0, -2.0, 1 - 3j, -1 + 1e-3j):
        assert twg.sqrt_pos_imag(z) == jwg.sqrt_pos_imag(z)
    # a term function maps tensors to complex128 CPU tensors
    tnep = neptpu_torch.nep_gallery("waveguide", neptype="SPMF", device=CPU,
                                    **CASES["tausch"])
    S = torch.tensor([[0.3 + 0.1j, 0.0], [1.0, 0.3 + 0.1j]],
                     dtype=torch.complex128)
    F = tnep.fv[5](S)
    assert isinstance(F, torch.Tensor) and F.dtype == torch.complex128
    assert F.device.type == "cpu" and F.shape == (2, 2)


def test_mixed_bank_structure_matches_jax(weps):
    """The wep bank: three banded main terms and the boundary terms as
    stacked low-rank factors.  From n = 512 on (the JARLEBRING case here, and
    the full-size problems) the main part is a DIA bank of seven offsets
    ``(-nz, -nz+1, -1, 0, 1, nz-1, nz)``; below, an aligned CSR bank."""
    tnep, _, nz = weps
    mats, _ = collect_spmf_terms(tnep)
    jb = jax_make_mixed_bank(mats, dtype=np.float64)
    tb = make_mixed_bank(mats, dtype=np.float64, device=CPU)
    assert type(tb.inner).__name__ == type(jb.inner).__name__
    assert tb.main_idx == jb.main_idx == (0, 1, 2)
    assert (tb.tidx_r, tb.tidx_i) == (jb.tidx_r, jb.tidx_i)
    for name in ("Lr", "Ur", "Li", "Ui"):
        assert tuple(getattr(tb, name).shape) == tuple(getattr(jb, name).shape)
    if tnep.n >= 512:
        assert isinstance(tb.inner, DiaTermBank)
        assert tb.inner.offsets == jb.inner.offsets == (
            -nz, -nz + 1, -1, 0, 1, nz - 1, nz)
    np.testing.assert_array_equal(tb.inner.data.numpy(),
                                  np.asarray(jb.inner.data))
    np.testing.assert_allclose(tb.fro_norms.numpy(), np.asarray(jb.fro_norms),
                               rtol=1e-13)


def test_mixed_bank_split_apply_matches_jax(weps):
    """f64 on both sides; the sums run in another order (rel 1e-12)."""
    tnep, _, _ = weps
    mats, _ = collect_spmf_terms(tnep)
    jb = jax_make_mixed_bank(mats, dtype=np.float64)
    tb = make_mixed_bank(mats, dtype=np.float64, device=CPU)
    rng = np.random.default_rng(43)
    Wre = rng.standard_normal((jb.n, jb.nterms))
    Wim = rng.standard_normal((jb.n, jb.nterms))
    # the scan hands the bank transposed (terms, n) products
    yre, yim = tb.lincomb_apply_split(torch.from_numpy(Wre.T.copy()).T,
                                      torch.from_numpy(Wim.T.copy()).T)
    jre, jim = jb.lincomb_apply_split(jnp.asarray(Wre), jnp.asarray(Wim))
    assert rel_err(yre.numpy(), np.asarray(jre)) < 1e-12
    assert rel_err(yim.numpy(), np.asarray(jim)) < 1e-12
    ref = sum(A @ (Wre[:, i] + 1j * Wim[:, i]) for i, A in enumerate(mats))
    assert rel_err(yre.numpy() + 1j * yim.numpy(), ref) < 1e-12


def test_native_format_waits_and_bad_arguments_raise():
    # the native format is ported: neptype="WEP" builds a WEP_FD
    nep = neptpu_torch.nep_gallery("waveguide", nx=11, nz=9, neptype="WEP",
                                   device=CPU)
    assert isinstance(nep, neptpu_torch.WEP_FD) and nep.n == 11 * 9 + 18
    with pytest.raises(ValueError, match="odd"):
        neptpu_torch.nep_gallery("waveguide", nx=11, nz=8, neptype="SPMF",
                                 device=CPU)
    with pytest.raises(ValueError, match="not supported"):
        neptpu_torch.nep_gallery("waveguide", nx=11, nz=9, neptype="FEM",
                                 device=CPU)
    with pytest.raises(ValueError, match="not supported"):
        neptpu_torch.nep_gallery("waveguide", nx=11, nz=9, neptype="SPMF",
                                 benchmark_problem="other", device=CPU)


def test_sqrt_derivative_matches_jax_on_seeded_inputs():
    """The scalar Gegenbauer recurrence against the JAX package's on seeded
    ``(a, b, c, d, x)`` and against the row form on the same row (rel
    1e-14 entry by entry)."""
    rng = np.random.default_rng(7)
    for _ in range(5):
        a = float(rng.uniform(0.5, 2.0))
        b, c, x = rng.standard_normal(3) + 1j * rng.standard_normal(3)
        d = int(rng.integers(0, 40))
        got = twg.sqrt_derivative(a, b, c, d, x)
        np.testing.assert_allclose(got, jwg.sqrt_derivative(a, b, c, d, x),
                                   rtol=1e-14)
        np.testing.assert_allclose(
            got, twg.sqrt_derivative_rows([b], [c], d, x, a=a)[0],
            rtol=1e-14)


def test_wep_coefficient_table_takes_the_scalar_recurrence(monkeypatch):
    """The SPMF waveguide's derivative table (213-term form at nz = 21, 100
    derivatives, the scan's theta-scaled table) runs one scalar recurrence
    per boundary term - never the row recurrence on a single row, which
    made the table several times slower - and equals the table built
    through the row form to rel 1e-14 in every column (a derivative order's
    weights over the terms, against the column's largest; entries that
    cancel to 1e-21 differ in their last bits)."""
    from neptpu_torch.solvers.spmf_real import spmf_coeff_table

    tnep = neptpu_torch.nep_gallery("waveguide", neptype="SPMF", device=CPU,
                                    **CASES["jarlebring"])
    _, fv = collect_spmf_terms(tnep)
    sigma = LAMS[1]
    rows = twg.sqrt_derivative_rows

    def no_rows(*args, **kwargs):
        raise AssertionError("the table ran the row recurrence")

    monkeypatch.setattr(twg, "sqrt_derivative_rows", no_rows)
    table = spmf_coeff_table(fv, sigma, 1.0, 100, scaled=True)
    monkeypatch.setattr(twg, "sqrt_derivative_rows", rows)
    monkeypatch.setattr(twg, "sqrt_derivative",
                        lambda a, b, c, d=0, x=0.0:
                        rows([b], [c], d, x, a=a)[0])
    ref = spmf_coeff_table(fv, sigma, 1.0, 100, scaled=True)
    for got, want in zip(table, ref):
        assert got.shape == (len(fv), 101)
        scale = np.abs(want).max(axis=0)
        assert np.all(np.abs(got - want).max(axis=0) <= 1e-14 * scale)
