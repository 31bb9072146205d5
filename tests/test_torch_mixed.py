"""Port parity: the mixed term bank (DIA main part + stacked low-rank
boundary factors) on the small gun-structured fixture."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, rel_err, small_gun_like, to_spec

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu.ops.mixed import make_mixed_bank as jax_make_mixed_bank
from neptpu.solvers.spmf_real import collect_spmf_terms as jax_collect
from neptpu_torch.interop import bank_from_arrays
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.solvers.spmf_real import collect_spmf_terms


@pytest.fixture(scope="module")
def gun_terms():
    ops = small_gun_like()
    return collect_spmf_terms(_gun_from_matrices(*ops, device=CPU)), jax_collect(
        jax_gun(*ops))


def test_collected_terms_match_jax(gun_terms):
    (mats, fv), (jmats, jfv) = gun_terms
    assert len(mats) == len(jmats) == len(fv) == len(jfv) == 4
    for A, B in zip(mats, jmats):
        assert abs(A - B).max() == 0
    for f, g in zip(fv, jfv):
        np.testing.assert_allclose(f.derivs(1250 + 5j, 6),
                                   g.derivs(1250 + 5j, 6), rtol=1e-15)


def test_mixed_bank_structure_matches_jax(gun_terms):
    (mats, _), _ = gun_terms
    jb = jax_make_mixed_bank(mats, dtype=np.float64)
    tb = make_mixed_bank(mats, dtype=np.float64, device=CPU)
    assert isinstance(tb.inner, DiaTermBank)
    assert tb.inner.offsets == jb.inner.offsets
    assert (tb.main_idx, tb.tidx_r, tb.tidx_i) == (jb.main_idx, jb.tidx_r,
                                                   jb.tidx_i)
    np.testing.assert_array_equal(tb.inner.data.numpy(),
                                  np.asarray(jb.inner.data))
    np.testing.assert_array_equal(tb.Lr.numpy(), np.asarray(jb.Lr))
    np.testing.assert_array_equal(tb.Ur.numpy(), np.asarray(jb.Ur))
    assert tb.Li is None and jb.Li is None
    np.testing.assert_allclose(tb.fro_norms.numpy(), np.asarray(jb.fro_norms),
                               rtol=1e-14)


# f64 on both sides; the sums run in another order (rel 1e-12)
@pytest.mark.parametrize("route", ["native", "interop"])
def test_lincomb_apply_split_matches_jax(gun_terms, route):
    (mats, _), _ = gun_terms
    jb = jax_make_mixed_bank(mats, dtype=np.float64)
    tb = (make_mixed_bank(mats, dtype=np.float64, device=CPU)
          if route == "native" else bank_from_arrays(to_spec(jb), device=CPU))
    rng = np.random.default_rng(11)
    n, m = jb.n, jb.nterms
    Wre = rng.standard_normal((n, m))
    Wim = rng.standard_normal((n, m))
    yre, yim = tb.lincomb_apply_split(torch.from_numpy(Wre),
                                      torch.from_numpy(Wim))
    jre, jim = jb.lincomb_apply_split(jnp.asarray(Wre), jnp.asarray(Wim))
    assert rel_err(yre.numpy(), np.asarray(jre)) < 1e-12
    assert rel_err(yim.numpy(), np.asarray(jim)) < 1e-12
    y = tb.lincomb_apply(torch.from_numpy(Wre + 1j * Wim)).numpy()
    assert rel_err(y, np.asarray(jre) + 1j * np.asarray(jim)) < 1e-12
    # and against the scipy terms themselves
    ref = sum(A @ (Wre[:, i] + 1j * Wim[:, i]) for i, A in enumerate(mats))
    assert rel_err(y, ref) < 1e-12


# the term-major split apply is the row-major one's body: equal bit for bit,
# with the main terms a slice of the operand (gun: terms 0, 1) or a gather
# (main terms not consecutive)
@pytest.mark.parametrize("order", [(0, 1, 2, 3), (0, 2, 1, 3), (2, 0, 3, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_term_major_split_apply_equals_row_major(gun_terms, order, dtype):
    (mats, _), _ = gun_terms
    mats = [mats[i] for i in order]
    tb = make_mixed_bank(mats, dtype=dtype, device=CPU)
    consecutive = tb.main_idx == tuple(range(tb.main_idx[0],
                                             tb.main_idx[-1] + 1))
    assert isinstance(tb._sel, slice) == consecutive
    rng = np.random.default_rng(12)
    n, m = tb.n, tb.nterms
    WreT = torch.from_numpy(rng.standard_normal((m, n)).astype(dtype))
    WimT = torch.from_numpy(rng.standard_normal((m, n)).astype(dtype))
    yre, yim = tb.lincomb_apply_split_t(WreT, WimT)
    zre, zim = tb.lincomb_apply_split(WreT.T.contiguous(),
                                      WimT.T.contiguous())
    assert torch.equal(yre, zre) and torch.equal(yim, zim)
    ref = sum(A @ (WreT[i].numpy() + 1j * WimT[i].numpy())
              for i, A in enumerate(mats))
    # float64 1e-12, float32 1e-5: reordered sums over n = 576 rows
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert rel_err(yre.numpy() + 1j * yim.numpy(), ref) < tol
    # the real single-operand apply takes the same main selection
    y = tb.lincomb_apply(WreT.T.contiguous())
    assert rel_err(y.numpy(), ref.real - sum(
        A @ (1j * WimT[i].numpy()) for i, A in enumerate(mats)).real) < tol
