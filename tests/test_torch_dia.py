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
    with pytest.raises(ValueError, match="CUDA"):
        dia_kernel.dia_lincomb(data, (-1, 0, 1), torch.zeros(
            (2, 10), dtype=torch.bfloat16))


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
        tb.data, tb.offsets, torch.from_numpy(Wre.T.copy()),
        torch.from_numpy(Wim.T.copy()))
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
    offs = (-1, 0, 1)
    W = torch.zeros((2, 10), device="meta")
    cpu = (torch.zeros((2, 3, 10)), offs, torch.zeros((2, 10)),
           torch.zeros((2, 10)))
    for args in ((data, offs, W, W), cpu):  # neither is a CUDA tensor
        with pytest.raises(ValueError, match="CUDA"):
            dia_kernel.dia_lincomb_pair(*args)
    with pytest.raises(ValueError, match="CUDA"):
        dia_kernel.empty_launch("cpu")
    assert set(dia_kernel.DIA_SPMV.counts) == {"dia_lincomb",
                                               "dia_lincomb_pair"}
    assert dia_kernel.DIA_SPMV.launches == sum(
        dia_kernel.DIA_SPMV.counts.values())


# offsets with odd, even, zero and out-of-range-at-the-edges values (|off|
# up to n - 1 and beyond), n a multiple of neither 2 nor 4
EDGE_OFFS = [-37, -36, -3, -2, -1, 0, 1, 2, 4, 7, 36, 38]
EDGE_N = 37


def _random_bank(offs, n, m, dtype, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((m, len(offs), n)).astype(dtype)
    WT = rng.standard_normal((2, m, n)).astype(dtype)
    return data, WT


def _dense_apply(data, offs, WT):
    """The definition, in float64: y[r] = sum data[i, d, r] WT[i, r + off]."""
    m, _, n = data.shape
    y = np.zeros(n)
    for d, off in enumerate(offs):
        for r in range(max(0, -off), min(n, n - off)):
            y[r] += data[:, d, r].astype(np.float64) @ WT[:, r + off]
    return y


# the term-major twins against the definition (a few roundings of the
# dtype per row, relative to max |y|) and, bit for bit, against the bank's
# term-major and row-major entries
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
def test_term_major_twins_and_bank_entries(m, dtype, rtol):
    data, WT = _random_bank(EDGE_OFFS, EDGE_N, m, dtype, seed=20 + m)
    tdata, tWT = torch.from_numpy(data), torch.from_numpy(WT)
    y = dia_kernel.dia_lincomb_plain(tdata, EDGE_OFFS, tWT[0])
    ref = _dense_apply(data, EDGE_OFFS, WT[0].astype(np.float64))
    assert y.numpy().dtype == dtype
    assert np.abs(y.numpy() - ref).max() <= rtol * np.abs(ref).max()
    pre, pim = dia_kernel.dia_lincomb_pair_plain(tdata, EDGE_OFFS, tWT[0],
                                                 tWT[1])
    assert torch.equal(pre, y)
    assert torch.equal(pim, dia_kernel.dia_lincomb_plain(tdata, EDGE_OFFS,
                                                         tWT[1]))
    tb = DiaTermBank(tdata, EDGE_OFFS, (EDGE_N, EDGE_N))
    W = tWT.transpose(1, 2).contiguous()  # the row-major operands (n, m)
    assert torch.equal(tb.lincomb_apply_t(tWT[0]), y)
    assert torch.equal(tb.lincomb_apply(W[0]), y)
    for entry, ops in ((tb.lincomb_apply_pair_t, tWT),
                       (tb.lincomb_apply_split_t, tWT),
                       (tb.lincomb_apply_pair, W),
                       (tb.lincomb_apply_split, W)):
        yre, yim = entry(ops[0], ops[1])
        assert torch.equal(yre, pre) and torch.equal(yim, pim)
    yc = tb.lincomb_apply_t(torch.complex(tWT[0], tWT[1]))
    assert torch.equal(yc.real, pre) and torch.equal(yc.imag, pim)


# the same through the JAX bank and the TPU kernel in interpret mode (its
# operand is row-major (n, m); float32 only for Pallas)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
def test_term_major_apply_matches_jax_and_pallas_interpret(m, dtype, rtol):
    offs = [o for o in EDGE_OFFS if abs(o) < EDGE_N]  # what the JAX bank takes
    data, WT = _random_bank(offs, EDGE_N, m, dtype, seed=30 + m)
    tb = DiaTermBank(torch.from_numpy(data), offs, (EDGE_N, EDGE_N))
    jb = JaxDiaTermBank(jnp.asarray(data), offs, (EDGE_N, EDGE_N))
    y = tb.lincomb_apply_t(torch.from_numpy(WT[0])).numpy()
    W = jnp.asarray(WT[0].T)
    refs = [np.asarray(jb.lincomb_apply(W))]
    if dtype == np.float32:
        refs.append(np.asarray(dia_lincomb_pallas(
            jb.data, jb.offsets, W, block_rows=8, interpret=True)))
    for ref in refs:
        assert np.abs(y - ref).max() <= rtol * np.abs(ref).max()


def test_bf16_term_major_entries_give_float32():
    data, WT = _random_bank(EDGE_OFFS, EDGE_N, 3, np.float32, seed=40)
    tb = DiaTermBank(torch.from_numpy(data).to(torch.bfloat16), EDGE_OFFS,
                     (EDGE_N, EDGE_N))
    W16 = torch.from_numpy(WT).to(torch.bfloat16)
    y = tb.lincomb_apply_t(W16[0])
    yre, yim = tb.lincomb_apply_pair_t(W16[0], W16[1])
    assert y.dtype == yre.dtype == yim.dtype == torch.float32
    assert torch.equal(y, yre)
    assert torch.equal(yre, tb.lincomb_apply(W16[0].T.contiguous()))
    # exact float32 products of the rounded inputs, float32 sums
    ref = _dense_apply(tb.data.to(torch.float64).numpy(), EDGE_OFFS,
                       W16[0].to(torch.float64).numpy())
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_wide_bank_term_major_twin_matches_the_definition():
    offs = list(range(-40, 41, 3)) + [1, 2]  # 29 offsets: the gather branch
    data, WT = _random_bank(offs, EDGE_N, 2, np.float64, seed=41)
    y = dia_kernel.dia_lincomb_plain(torch.from_numpy(data), offs,
                                     torch.from_numpy(WT[0])).numpy()
    ref = _dense_apply(data, offs, WT[0])
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


# the prepared launcher's operand checks run before anything is built or
# launched, so the CPU reaches them: dtype, shape, contiguity, then device
@pytest.mark.parametrize("operand,error,match", [
    (lambda: torch.zeros((2, 10), dtype=torch.float64), TypeError,
     "one dtype"),
    (lambda: torch.zeros((10, 2)), ValueError, "term-major"),
    (lambda: torch.zeros((2, 9)), ValueError, "term-major"),
    (lambda: torch.zeros((10, 2)).T, ValueError, "contiguous"),
    (lambda: torch.zeros((2, 20))[:, ::2], ValueError, "contiguous"),
    (lambda: torch.zeros((2, 10)), ValueError, "CUDA"),
    (lambda: torch.zeros((2, 10), device="meta"), ValueError, "CUDA"),
])
@pytest.mark.parametrize("entry", ["single", "pair"])
def test_prepared_launcher_refuses_what_the_kernel_does_not_take(
        operand, error, match, entry):
    launcher = dia_kernel.DiaLauncher(torch.zeros((2, 3, 10)), (-1, 0, 1))
    before = dict(dia_kernel.DIA_SPMV.entry_counts)
    good = torch.zeros((2, 10))
    with pytest.raises(error, match=match):
        if entry == "single":
            launcher.single(operand())
        else:
            launcher.pair(operand(), good)
    assert dia_kernel.DIA_SPMV.entry_counts == before


def test_prepared_launcher_validates_the_bank_once():
    ok = torch.zeros((2, 3, 10))
    for data, offs, error in (
            (ok.to(torch.float16), (-1, 0, 1), TypeError),
            (ok[0], (-1, 0, 1), ValueError),
            (ok.transpose(1, 2), (-1, 0, 1), ValueError),
            (ok, (-1, 0), ValueError),
            (ok, (-1, 0, 2**31), ValueError)):
        with pytest.raises(error):
            dia_kernel.DiaLauncher(data, offs)
    launcher = dia_kernel.DiaLauncher(ok, (-1, 0, 1))
    assert (launcher.m, launcher.ndiag, launcher.n) == (2, 3, 10)
    assert launcher.vec == 1


# rows per thread follow from what the launcher can see: the dtype's packed
# width (bfloat16 only) where n keeps every bank row aligned and there are
# rows enough to fill the card with packed loads, else one
@pytest.mark.parametrize("dtype,n,expected", [
    (torch.float32, 9956, 1), (torch.float32, 11655, 1),
    (torch.float64, 10_000, 1), (torch.float32, 1_000_000, 1),
    (torch.float64, 1_000_000, 1), (torch.bfloat16, 1_000_000, 8),
    (torch.bfloat16, 1_000_004, 1), (torch.bfloat16, 10_000, 1),
    (torch.bfloat16, 1 << 17, 8), (torch.bfloat16, (1 << 17) - 8, 1),
])
def test_rows_per_thread_follows_dtype_and_rows(dtype, n, expected):
    assert dia_kernel.rows_per_thread(dtype, n) == expected
    launcher = dia_kernel.DiaLauncher(torch.zeros((1, 1, n), dtype=dtype), (0,))
    assert launcher.vec == expected
