"""Port parity: the utilities — the sparse-matrix text files, the benchmark
harness, the mpmath extended-precision Newton — and the CSR SpMV/SpMM of
``ops/sparse.py``, against the JAX package on the CPU."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import CPU, gallery_pair, rel_err

import neptpu
import neptpu_torch
from neptpu_torch import utils
from neptpu_torch.ops.sparse import CSR, spmm, spmv


def _random_sparse(seed, m=9, n=7):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=0.3, random_state=rng, format="csr")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sparse_matrix_file_crosses_packages(tmp_path, writer):
    """A file written by one package reads back the same in the other (and
    through the gallery's loader)."""
    A = _random_sparse(0)
    path = str(tmp_path / "A.txt")
    (neptpu if writer == "jax" else neptpu_torch).write_sparse_matrix(path, A)
    other = neptpu_torch if writer == "jax" else neptpu
    for pkg in (neptpu, neptpu_torch):
        B = (other if pkg is other else pkg).read_sparse_matrix(path)
        assert B.shape == A.shape and abs(B - A).max() == 0
    assert utils.read_sparse_matrix is neptpu_torch.read_sparse_matrix


def test_benchmarker_history_lines(tmp_path):
    """The port's records carry the JAX package's keys; both packages read
    each other's history and render one trend table over it."""
    from neptpu.utils.benchmark import Benchmarker as JB
    from neptpu.utils.benchmark import render_report as jreport

    path = str(tmp_path / "hist.json")
    bt = utils.Benchmarker(repeats=2)
    assert bt.run("square", lambda x: x * x, 3) == 9
    rt = bt.save(path, extra={"device": "cpu"})
    bj = JB(repeats=2)
    bj.run("square", lambda x: x * x, 3)
    rj = bj.save(path)
    assert set(rj) <= set(rt) and rt["device"] == "cpu"
    hist = utils.load_history(path)
    assert len(hist) == 2 and json.load(open(path)) == hist
    assert utils.render_report(path) == jreport(path)
    lines = utils.render_report(path).splitlines()
    assert lines[0].startswith("benchmark trend") and len(lines) == 3
    assert utils.render_report(str(tmp_path / "none.json")) == (
        "(no benchmark history)")


def test_newton_mp_matches_jax():
    """The extended-precision Newton on the mirrored real_quadratic: the
    same eigenvalue as the JAX package's to 1e-40, its residual far below
    float64's; the mirrored delay problem dep1 gives the same mp matrices
    as the JAX package's mirror."""
    import mpmath as mp

    from neptpu.utils import extended as je

    tn, jn = gallery_pair("real_quadratic")
    # the default tolerance, 100 eps(prec) absolute, is below what an
    # operand norm of 1e3 admits: ask for 1e-45
    kw = dict(lam0=-4.0, v0=np.ones(4), prec=200, tol=mp.mpf(10) ** -45)
    lt, vt = utils.newton_mp(utils.mp_from_nep(tn, prec=200), **kw)
    lj, vj = je.newton_mp(je.mp_from_nep(jn, prec=200), **kw)
    assert abs(lt - lj) < mp.mpf(10) ** -40
    assert abs(lt - (-4.039879577113)) < 1e-11
    assert utils.resnorm_mp(utils.mp_from_nep(tn, prec=200), lt,
                            vt) < mp.mpf(10) ** -40
    tn, jn = gallery_pair("dep1")
    mt, mj = utils.mp_from_nep(tn, prec=128), je.mp_from_nep(jn, prec=128)
    for der in (0, 1):
        assert mp.norm(mt.mder(0.3 + 0.1j, der) - mj.mder(0.3 + 0.1j, der)
                       ) < mp.mpf(10) ** -30
    with pytest.raises(TypeError, match="cannot mirror"):
        utils.mp_from_nep(neptpu_torch.nep_gallery(
            "waveguide", nx=5, nz=3, neptype="WEP", device=CPU))


def test_newton_mp_reports_no_convergence():
    tn, _ = gallery_pair("real_quadratic")
    with pytest.raises(neptpu_torch.NoConvergenceException) as ei:
        utils.augnewton_mp(utils.mp_from_nep(tn, prec=64), lam0=1e6,
                           v0=np.ones(4), maxit=2)
    assert ei.value.lam is not None and ei.value.v is not None


def test_csr_spmv_spmm_match_jax():
    from neptpu.ops.sparse import CSR as JCSR
    from neptpu.ops.sparse import spmm as jspmm
    from neptpu.ops.sparse import spmv as jspmv

    A = _random_sparse(1, 30, 20) + _random_sparse(2, 30, 20) * 1j
    At = CSR.from_scipy(A, device=CPU)
    Aj = JCSR.from_scipy(A)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(20)
    X = rng.standard_normal((20, 4))
    assert rel_err(spmv(At, torch.as_tensor(x)).numpy(),
                   np.asarray(jspmv(Aj, x))) < 1e-15
    assert rel_err(spmm(At, torch.as_tensor(X)).numpy(),
                   np.asarray(jspmm(Aj, X))) < 1e-15
    assert rel_err((At @ torch.as_tensor(X)).numpy(), A @ X) < 1e-15
    assert rel_err(At.to_dense().numpy(), A.toarray()) == 0
    real = CSR.from_scipy(A.real, dtype=np.float32, device=CPU)
    assert real.dtype == torch.float32 and real.nnz == A.real.nnz
