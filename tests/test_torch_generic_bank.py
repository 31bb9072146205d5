"""Port parity for the banks kernel B1's generic body takes (more than 16
offsets or more than 4 terms): the plain twin against the JAX package's
Pallas kernel (interpret mode) and its ``DiaTermBank.lincomb_apply``, a
quartic ``PEP``'s ``compute_Mlincomb`` against the JAX package's, and the
generic body's launch plan (``generic_plan``) - its staged windows and its
fixed summation order, replayed in numpy - against the twin, on the CPU."""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.ops import dia_kernel
from neptpu_torch.ops.dia import DiaTermBank

jdia = importlib.import_module("neptpu.ops.dia")
jpallas = importlib.import_module("neptpu.ops.pallas_spmv")


def _stencil(n):
    """The SpMV headline's nine offsets on a sqrt(n) x sqrt(n) grid."""
    w = int(round(np.sqrt(n)))
    return (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1)


def _mats(offs, n, m, seed):
    rng = np.random.default_rng(seed)
    return [sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                     shape=(n, n), format="csr") for _ in range(m)]


# (n, m, offsets): a quartic PEP's bank on the stencil, a wide band, and more
# offsets than ride in the kernel's parameter block
SHAPES = [(2048, 5, _stencil(2048)), (1500, 2, tuple(range(-20, 21))),
          (1200, 1, tuple(range(-150, 150)))]


# tolerances: a few roundings of the data type per row (the sums run in
# another order in each implementation)
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("n,m,offs", SHAPES)
def test_twin_matches_jax_bank_and_pallas(dtype, rtol, n, m, offs):
    mats = _mats(offs, n, m, seed=n)
    jb = jdia.DiaTermBank.from_matrices(mats, dtype=dtype)
    tb = DiaTermBank.from_matrices(mats, dtype=dtype, device=CPU)
    assert dia_kernel.is_generic(tb.nterms, tb.ndiag)
    W = np.random.default_rng(1).standard_normal((n, m)).astype(dtype)
    y = dia_kernel.dia_lincomb_plain(tb.data, tb.offsets,
                                     torch.from_numpy(W.T.copy())).numpy()
    assert y.dtype == dtype
    assert rel_err(y, np.asarray(jb.lincomb_apply(jnp.asarray(W)))) < rtol
    # the bank's own entry takes the same twin on the CPU
    assert np.array_equal(tb.lincomb_apply(torch.from_numpy(W)).numpy(), y)
    if dtype == np.float32:
        # the TPU kernel takes float32 and bfloat16 only
        y_pal = np.asarray(jpallas.dia_lincomb_pallas(
            jb.data, jb.offsets, jnp.asarray(W), block_rows=256,
            interpret=True))
        assert rel_err(y, y_pal) < rtol


def test_quartic_pep_mlincomb_matches_jax():
    """A quartic PEP on the stencil at n = 4096 (a five-term DIA bank, the
    generic body's on the card): ``compute_Mlincomb`` with three derivative
    columns at two shifts, complex128, within 1e-12 of the JAX package's."""
    n = 4096
    mats = _mats(_stencil(n), n, 5, seed=0)
    tnep = neptpu_torch.PEP(mats, device=CPU)
    jnep = neptpu.PEP(mats)
    assert isinstance(tnep.bank, DiaTermBank) and tnep.bank.nterms == 5
    assert dia_kernel.is_generic(tnep.bank.nterms, tnep.bank.ndiag)
    rng = np.random.default_rng(2)
    V = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    for lam in (0.7, -0.4 + 0.3j):
        y = neptpu_torch.compute_Mlincomb(tnep, lam, torch.from_numpy(V))
        jy = neptpu.compute_Mlincomb(jnep, lam, jnp.asarray(V))
        assert rel_err(y.numpy(), np.asarray(jy)) < 1e-12
        ya = neptpu_torch.compute_Mlincomb(tnep, lam, torch.from_numpy(V),
                                           a=[1.0, -2.0, 0.5], startder=1)
        jya = neptpu.compute_Mlincomb(jnep, lam, jnp.asarray(V),
                                      a=jnp.asarray([1.0, -2.0, 0.5]),
                                      startder=1)
        assert rel_err(ya.numpy(), np.asarray(jya)) < 1e-12


def _replay(data, offs, WT, plan):
    """The generic body's arithmetic in numpy (float64 data): the operand of
    each staged diagonal read from its cluster's window (built tile by tile,
    zero outside [0, n)), every other diagonal's from W itself; each row
    summed as the kernel sums it - eight fixed runs of the (diagonal, term)
    streams, each from zero, then the runs in order."""
    m, ndiag, n = data.shape
    tile = plan.tile
    y = np.zeros(n)
    streams = [(d, i) for d in range(ndiag) for i in range(m)]
    S = len(streams)
    bounds = [S * g // dia_kernel.GENERIC_RUNS
              for g in range(dia_kernel.GENERIC_RUNS + 1)]
    for r0 in range(0, n, tile):
        rows = np.arange(r0, min(r0 + tile, n))
        t = rows - r0
        win = np.full((m, plan.window), np.nan)  # unstaged reads show
        for start, length, base in plan.clusters:
            c = r0 + start + np.arange(length)
            inside = (c >= 0) & (c < n)
            win[:, base:base + length] = 0.0
            win[:, base:base + length][:, inside] = WT[:, c[inside]]
        total = None
        for g in range(dia_kernel.GENERIC_RUNS):
            acc = np.zeros(len(rows))
            for d, i in streams[bounds[g]:bounds[g + 1]]:
                pos = plan.pos[d]
                if pos >= 0:
                    w = win[i, pos + t]
                else:
                    c = rows + offs[d]
                    w = np.where((c >= 0) & (c < n),
                                 WT[i, np.clip(c, 0, n - 1)], 0.0)
                acc = acc + data[i, d, rows] * w
            total = acc if total is None else total + acc
        y[rows] = total
    return y


# itemsize 4 and 8 (one row a lane) and 2 (bfloat16 rows in pairs); the
# split regime (n below GENERIC_WIDE_ROWS) and, with that bound lowered, the
# other one; staged windows, unstaged clusters (the budget or the count of
# windows runs out) and no windows at all
@pytest.mark.parametrize("itemsize,gvec", [(4, 1), (8, 1), (2, 2)])
@pytest.mark.parametrize("n,m,offs", [
    (2048, 5, _stencil(2048)), (1500, 2, tuple(range(-20, 21))),
    (1201, 6, tuple(range(-10, 9))), (1200, 1, tuple(range(-150, 150))),
    (5000, 8, tuple(range(-2000, 2000, 100))),
    (3000, 2, tuple(sorted(a * 300 + b * 17 + c for a in (-1, 0, 1)
                           for b in (-1, 0, 1) for c in (-1, 0, 1)))),
    (700, 5, (3,))])
@pytest.mark.parametrize("wide_rows", [None, 512])
def test_generic_plan_replays_to_the_twin(itemsize, gvec, n, m, offs,
                                          wide_rows, monkeypatch):
    if gvec == 2 and n % 2:
        gvec = 1  # bfloat16 rows go in pairs only at even n (the launcher's)
    if wide_rows is not None:
        monkeypatch.setattr(dia_kernel, "GENERIC_WIDE_ROWS", wide_rows)
    plan = dia_kernel.generic_plan(offs, n, m, itemsize, gvec)
    assert plan.split == (n < dia_kernel.GENERIC_WIDE_ROWS)
    # the windows of a pair launch fit the block's shared memory, and so do
    # the warps' partial sums of the split regime
    assert 2 * m * plan.window * itemsize <= dia_kernel.GENERIC_SMEM
    acc = 8 if itemsize == 8 else 4
    if plan.split:
        assert (dia_kernel.GENERIC_RUNS * 2 * plan.tile * acc
                <= dia_kernel.GENERIC_SMEM)
    assert len(plan.clusters) <= dia_kernel.MAX_CLUSTERS
    for start, length, base in plan.clusters:
        assert start % 2 == 0 and length % 2 == 0 and base % 2 == 0
    rng = np.random.default_rng(3)
    data = rng.standard_normal((m, len(offs), n))
    WT = rng.standard_normal((m, n))
    ref = dia_kernel.dia_lincomb_plain(torch.from_numpy(data), offs,
                                       torch.from_numpy(WT)).numpy()
    y = _replay(data, offs, WT, plan)
    assert np.all(np.isfinite(y))  # no read outside a staged window
    assert rel_err(y, ref) < 1e-12
    # the same bits without windows, and in the other regime: the order of
    # the sums does not depend on where the operand comes from or the tile
    bare = dia_kernel.generic_plan(offs, n, m, itemsize, gvec, stage=False)
    assert bare.clusters == () and set(bare.pos) == {-1}
    assert np.array_equal(_replay(data, offs, WT, bare), y)


def test_generic_plan_clusters_a_27_point_stencil():
    """A 27-point stencil on a 50^3 grid (the split kernel's range): three
    windows of span 102 (offsets within 2551 of each other join only where
    the gap is at most a tile), every diagonal staged.  At n = 1e6 (a 100^3
    grid, the quartic bank) the rows kernel reads through L1: no window."""
    def stencil27(w):
        return tuple(sorted(dz * w * w + dy * w + dx for dz in (-1, 0, 1)
                            for dy in (-1, 0, 1) for dx in (-1, 0, 1)))

    plan = dia_kernel.generic_plan(stencil27(50), 50**3, 2, 4)
    assert plan.split and plan.tile == 64
    assert len(plan.clusters) == 3 and min(plan.pos) >= 0
    assert [length for _, length, _ in plan.clusters] == [64 + 102 + 2] * 3
    # bfloat16 in pairs: twice the tile
    assert dia_kernel.generic_plan(stencil27(50), 50**3, 2, 2, 2).tile == 128
    for offs, m in ((stencil27(100), 2), (_stencil(10**6), 5)):
        for itemsize, gvec, tile in ((4, 1, 512), (8, 1, 256), (2, 2, 512),
                                     (2, 1, 512)):
            wide = dia_kernel.generic_plan(offs, 10**6, m, itemsize, gvec)
            assert not wide.split and wide.tile == tile
            assert wide.clusters == () and set(wide.pos) == {-1}


def test_launcher_carries_the_plan_and_counts_nothing_on_the_cpu():
    """The prepared launch holds the plan in the struct the kernel reads;
    a narrow bank has none.  On the CPU the bank's entries take the twin and
    launch nothing."""
    offs = tuple(range(-150, 150))
    data = torch.zeros((1, len(offs), 1200))
    launcher = dia_kernel.DiaLauncher(data, offs)
    assert launcher.generic and launcher.plan.pos[0] >= 0
    cl = launcher._bank.clusters
    assert cl.count == len(launcher.plan.clusters)
    assert cl.window == launcher.plan.window
    assert list(launcher._bank.pos[:4]) == list(launcher.plan.pos[:4])
    assert launcher._bank.rows == launcher.plan.rows == 2
    assert launcher._bank.split == 1
    narrow = dia_kernel.DiaLauncher(torch.zeros((4, 9, 100)), _stencil(100))
    assert not narrow.generic and narrow.plan is None
    bank = DiaTermBank(data.double(), offs, (1200, 1200))
    before = dia_kernel.DIA_SPMV.snapshot()
    bank.lincomb_apply_pair_t(torch.ones((1, 1200), dtype=torch.float64),
                              torch.ones((1, 1200), dtype=torch.float64))
    assert dia_kernel.DIA_SPMV.snapshot() == before
