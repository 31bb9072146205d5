"""Port parity: the stacked-DIA bank and its fused multi-term SpMV.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
bank's CPU path (the kernel's plain twin) is held against the JAX package's
``DiaTermBank.lincomb_apply`` and against the TPU Pallas kernel run in
interpret mode, and the dispatch is checked to never fall back silently.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, rel_err

from neptpu.ops.dia import DiaTermBank as JaxDiaTermBank
from neptpu.ops.pallas_spmv import dia_lincomb_pallas
from neptpu_torch.ops import dia_kernel
from neptpu_torch.ops.dia import DiaTermBank

# the TPU kernel's parity test shape (tests/test_infra.py)
N, M_TERMS = 700, 3
OFFS = [-26, -25, -1, 0, 1, 25, 26]


def _mats(offs, n, m, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [sp.diags([rng.standard_normal(n - abs(o)).astype(dtype)
                      for o in offs], offs, shape=(n, n), format="csr")
            for _ in range(m)]


def test_from_matrices_matches_jax_exactly():
    mats = _mats(OFFS, N, M_TERMS, np.float64)
    jb = JaxDiaTermBank.from_matrices(mats)
    tb = DiaTermBank.from_matrices(mats, device=CPU)
    assert tb.offsets == jb.offsets
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_allclose(tb.fro_norms.numpy(), np.asarray(jb.fro_norms),
                               rtol=1e-15)


# tolerances: a few roundings of the data dtype per output row (the sums
# run in another order than in XLA)
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-13)])
def test_lincomb_apply_matches_jax_and_pallas_interpret(dtype, rtol):
    mats = _mats(OFFS, N, M_TERMS, dtype)
    jb = JaxDiaTermBank.from_matrices(mats, dtype=dtype)
    tb = DiaTermBank.from_matrices(mats, dtype=dtype, device=CPU)
    W = np.random.default_rng(4).standard_normal((N, M_TERMS)).astype(dtype)
    y_jax = np.asarray(jb.lincomb_apply(jnp.asarray(W)))
    y = tb.lincomb_apply(torch.from_numpy(W)).numpy()
    assert y.dtype == dtype
    assert rel_err(y, y_jax) < rtol
    if dtype == np.float32:
        # the Pallas kernel takes float32/bfloat16 only (it traces with x64
        # off), so it is the float32 case's second reference
        y_pal = np.asarray(dia_lincomb_pallas(
            jb.data, jb.offsets, jnp.asarray(W), block_rows=256,
            interpret=True))
        assert rel_err(y, y_pal) < rtol


def test_wide_bank_matches_jax():
    """More than 16 offsets: the padded gather + einsum branch."""
    offs = list(range(-12, 13))
    mats = _mats(offs, 300, 2, np.float64, seed=5)
    jb = JaxDiaTermBank.from_matrices(mats)
    tb = DiaTermBank.from_matrices(mats, device=CPU)
    W = np.random.default_rng(6).standard_normal((300, 2))
    y_jax = np.asarray(jb.lincomb_apply(jnp.asarray(W)))
    y = tb.lincomb_apply(torch.from_numpy(W)).numpy()
    assert rel_err(y, y_jax) < 1e-13  # f64, reordered sums


def test_complex_operand_and_single_term_ops_match_jax():
    mats = _mats(OFFS, N, M_TERMS, np.float64, seed=7)
    jb = JaxDiaTermBank.from_matrices(mats)
    tb = DiaTermBank.from_matrices(mats, device=CPU)
    rng = np.random.default_rng(8)
    W = (rng.standard_normal((N, M_TERMS))
         + 1j * rng.standard_normal((N, M_TERMS)))
    y = tb.lincomb_apply(torch.from_numpy(W)).numpy()
    assert rel_err(y, np.asarray(jb.lincomb_apply(jnp.asarray(W)))) < 1e-13
    w = np.array([0.5, -1.25 + 0.5j, 2.0])
    x = rng.standard_normal(N)
    y1 = tb.combine(torch.from_numpy(w)).matvec(torch.from_numpy(x)).numpy()
    y1_jax = np.asarray(jb.combine(jnp.asarray(w)).matvec(jnp.asarray(x)))
    assert rel_err(y1, y1_jax) < 1e-13
    np.testing.assert_allclose(tb.term(1).to_dense().numpy(),
                               np.asarray(jb.term(1).to_dense()), rtol=0,
                               atol=0)
    for A, B in zip(tb.host_csr_terms(), jb.host_csr_terms()):
        assert abs(A - B).max() == 0


def test_cpu_apply_never_launches_the_kernel():
    mats = _mats(OFFS, N, M_TERMS, np.float32)
    tb = DiaTermBank.from_matrices(mats, dtype=np.float32, device=CPU)
    before = dia_kernel.DIA_SPMV.launches
    tb.lincomb_apply(torch.ones((N, M_TERMS), dtype=torch.float32))
    assert dia_kernel.DIA_SPMV.launches == before


def test_non_cpu_device_goes_to_the_kernel_or_raises():
    """No silent fallback: a tensor on a device other than the CPU (here
    'meta', where no kernel can load or launch) must raise instead of
    returning the twin's result."""
    mats = _mats(OFFS, N, M_TERMS, np.float32)
    tb = DiaTermBank.from_matrices(mats, dtype=np.float32, device="meta")
    W = torch.empty((N, M_TERMS), dtype=torch.float32, device="meta")
    before = dia_kernel.DIA_SPMV.launches
    with pytest.raises(ValueError, match="CUDA"):
        tb.lincomb_apply(W)
    assert dia_kernel.DIA_SPMV.launches == before


def test_kernel_wrapper_rejects_what_it_does_not_take():
    data = torch.zeros((2, 3, 10), dtype=torch.bfloat16)
    offs = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((10, 2)))


# the pair twin is two plain applies: same tolerances as the single apply
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-13)])
def test_pair_apply_matches_jax_and_pallas_interpret(dtype, rtol):
    mats = _mats(OFFS, N, M_TERMS, dtype)
    jb = JaxDiaTermBank.from_matrices(mats, dtype=dtype)
    tb = DiaTermBank.from_matrices(mats, dtype=dtype, device=CPU)
    rng = np.random.default_rng(9)
    Wre = rng.standard_normal((N, M_TERMS)).astype(dtype)
    Wim = rng.standard_normal((N, M_TERMS)).astype(dtype)
    yre, yim = tb.lincomb_apply_pair(torch.from_numpy(Wre),
                                     torch.from_numpy(Wim))
    pre, pim = dia_kernel.dia_lincomb_pair_plain(
        tb.data, tb.offsets, torch.from_numpy(Wre), torch.from_numpy(Wim))
    assert torch.equal(yre, pre) and torch.equal(yim, pim)
    for y, W in ((yre, Wre), (yim, Wim)):
        assert y.numpy().dtype == dtype
        assert rel_err(y.numpy(),
                       np.asarray(jb.lincomb_apply(jnp.asarray(W)))) < rtol
        if dtype == np.float32:
            y_pal = np.asarray(dia_lincomb_pallas(
                jb.data, jb.offsets, jnp.asarray(W), block_rows=256,
                interpret=True))
            assert rel_err(y.numpy(), y_pal) < rtol
    # a complex operand is the pair apply of its parts
    yc = tb.lincomb_apply(torch.from_numpy(Wre + 1j * Wim))
    assert torch.equal(yc.real, yre.to(yc.real.dtype))
    assert torch.equal(yc.imag, yim.to(yc.imag.dtype))
    with pytest.raises(TypeError, match="real re/im"):
        tb.lincomb_apply_pair(torch.from_numpy(Wre + 0j),
                              torch.from_numpy(Wim))


def test_pair_apply_on_a_non_cpu_device_goes_to_the_kernel_or_raises():
    """No silent fallback for the pair either ('meta': nothing can launch),
    real or complex operand."""
    mats = _mats(OFFS, N, M_TERMS, np.float32)
    tb = DiaTermBank.from_matrices(mats, dtype=np.float32, device="meta")
    W = torch.empty((N, M_TERMS), dtype=torch.float32, device="meta")
    before = dict(dia_kernel.DIA_SPMV.counts)
    with pytest.raises(ValueError, match="CUDA"):
        tb.lincomb_apply_pair(W, W)
    with pytest.raises(ValueError, match="CUDA"):
        tb.lincomb_apply(torch.empty((N, M_TERMS), dtype=torch.complex64,
                                     device="meta"))
    assert dia_kernel.DIA_SPMV.counts == before


def test_pair_wrapper_rejects_what_it_does_not_take():
    data = torch.zeros((2, 3, 10), device="meta")
    offs = torch.zeros(3, dtype=torch.int32, device="meta")
    W = torch.zeros((10, 2), device="meta")
    cpu = (torch.zeros((2, 3, 10)), torch.zeros(3, dtype=torch.int32),
           torch.zeros((10, 2)), torch.zeros((10, 2)))
    for args in ((data, offs, W, W), cpu):  # neither is a CUDA tensor
        with pytest.raises(ValueError, match="CUDA"):
            dia_kernel.dia_lincomb_pair(*args)
    with pytest.raises(ValueError, match="CUDA"):
        dia_kernel.empty_launch("cpu")
    assert set(dia_kernel.DIA_SPMV.counts) == {"dia_lincomb",
                                               "dia_lincomb_pair"}
    assert dia_kernel.DIA_SPMV.launches == sum(
        dia_kernel.DIA_SPMV.counts.values())
