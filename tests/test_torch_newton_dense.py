"""Port parity: the dense Newton solvers for invariant pairs,
``blocknewton`` and ``broyden``, with the arguments and oracles of the JAX
package's tests (``tests/test_more_solvers.py``), against the JAX results on
the CPU in complex128.

``broyden``'s restart at its second pair picks an eigenvector of the
bordered matrix ``[[I, U1], [X^H, 0]]`` for an eigenvalue 1 of multiplicity
three (the start ``approxnep=":eye"``): a degenerate choice that last-bit
differences decide.  The two packages then land on the two members of the
conjugate pair -0.5032 +- 1.1970i of this real problem, so its eigenvalues
are held modulo conjugation."""
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, conj_set_gap, gallery_pair

import neptpu
import neptpu_torch

BROYDEN_ORACLES = [-0.15955391823299253,
                   -0.5032087003825461 + 1.1969823800738464j,
                   1.2699713558173726]


def _smin(tnep, lam):
    M = tnep.Mder_dense(complex(lam)).numpy()
    return np.linalg.svd(M, compute_uv=False)[-1]


def test_broyden_dep0_matches_jax():
    tnep, jnep = gallery_pair("dep0")
    S, X = neptpu_torch.broyden(tnep, device=CPU)
    Sj, Xj = neptpu.broyden(jnep)
    d = np.diag(S)
    assert S.shape == (3, 3) and X.shape == (5, 3) and X.device.type == "cpu"
    assert conj_set_gap(BROYDEN_ORACLES, d) < 1e-8
    assert conj_set_gap(d, np.diag(np.asarray(Sj))) < 1e-10
    for lam in d:
        assert _smin(tnep, lam) < 1e-10
    # (S, X) is an invariant pair: M(S, X) = sum_i A_i X f_i(S) ~ 0
    R = neptpu_torch.compute_MM(tnep, torch.from_numpy(S), X)
    assert float(torch.linalg.matrix_norm(R)) < 1e-9


def test_broyden_invpow_restart():
    """The inverse-power restart eigensolver on the same problem (its
    second pair to the accuracy a 1e-12 residual gives, ~1e-9)."""
    tnep, jnep = gallery_pair("dep0")
    S, _ = neptpu_torch.broyden(tnep, pmax=2, eigmethod=":invpow", device=CPU)
    Sj, _ = neptpu.broyden(jnep, pmax=2, eigmethod=":invpow")
    assert conj_set_gap(np.diag(S), np.diag(np.asarray(Sj))) < 1e-8
    with pytest.raises(ValueError, match="eig method"):
        neptpu_torch.broyden(tnep, eigmethod=":nope", device=CPU)


@pytest.mark.parametrize("S0", [np.zeros((3, 3)), np.diag([-0.2, 0.3]),
                                np.diag([0.1, 1.0])],
                         ids=["reference", "real-pair", "complex-pair"])
def test_blocknewton_matches_jax(S0):
    """The reference configuration (``S = 0`` of size 3, ``armijo_factor=
    0.5, maxit=20``; without them the JAX package's run breaks down in an
    SVD), and two invariant pairs of size 2 from diagonal starts."""
    tnep, jnep = gallery_pair("dep0", 4)
    p = S0.shape[0]
    kw = dict(S=S0, X=np.eye(4, p), maxit=20, armijo_factor=0.5)
    S, X = neptpu_torch.blocknewton(tnep, device=CPU, **kw)
    Sj, _ = neptpu.blocknewton(jnep, **kw)
    lam = np.linalg.eigvals(S)
    assert conj_set_gap(lam, np.linalg.eigvals(np.asarray(Sj))) < 1e-10
    for x in lam:
        assert _smin(tnep, x) < np.sqrt(np.finfo(float).eps)
    assert X.shape == (4, p) and X.device.type == "cpu"
