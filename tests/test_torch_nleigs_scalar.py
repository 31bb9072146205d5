"""Port parity: NLEIGS on the scalar, purely nonlinear problem
A(lam) = 0.2 sqrt(lam) - 0.6 sin(2 lam), in complex128 on the CPU.  The
polynomial variant finds the eigenvalues away from the square root's branch
cut; only the fully rational one (pole candidates on the negative axis)
also captures the one near 0.0278.  Eigenvalues to rel 1e-10 of the JAX
package's (as sets)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU

import neptpu
import neptpu_torch as nt


def _same_set(a, b, rel=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), (a, b)
    for x in a:
        assert np.min(np.abs(b - x)) <= rel * abs(x), (x, b)
    for x in b:
        assert np.min(np.abs(a - x)) <= rel * abs(x), (x, a)


def _scalar_problem(pkg):
    """0.2 sqrt(lam) - 0.6 sin(2 lam); a 1 x 1 argument takes the scalar
    functions (the matrix functions' iterations cost the JAX package a
    compilation per call there)."""
    A = [np.array([[0.2]]), np.array([[-0.6]])]
    if pkg is nt:
        from neptpu_torch.ops import matfun as tm

        def f1(S):
            return torch.sqrt(S) if S.shape[-1] == 1 else tm.sqrtm(S)

        def f2(S):
            return torch.sin(2 * S) if S.shape[-1] == 1 else tm.sinm(2 * S)

        return nt.SPMF_NEP(A, [f1, f2], check_consistency=False, device=CPU)
    from neptpu.ops import matfun as jm

    def g1(S):
        S = jnp.asarray(S)
        return jnp.sqrt(S) if S.shape[-1] == 1 else jm.sqrtm(S)

    def g2(S):
        S = jnp.asarray(S)
        return jnp.sin(2 * S) if S.shape[-1] == 1 else jm.sinm(2 * S)

    return neptpu.SPMF_NEP(A, [g1, g2], check_consistency=False)


@pytest.mark.parametrize("rational", [False, True])
def test_nleigs_scalar(rational):
    """A(lam) = 0.2 sqrt(lam) - 0.6 sin(2 lam): the polynomial variant and
    the fully rational one (poles on the branch cut, which also captures the
    eigenvalue near 0.0278)."""
    kw = dict(maxit=100, v=np.ones(1) + 0j, leja=2, isfunm=False)
    if rational:
        kw["Xi"] = -10.0 ** np.linspace(-6, 5, 10000)
    S = [0.01 + 0j, 4 + 0j]
    lt, _, _, _ = nt.nleigs(_scalar_problem(nt), S, device=CPU, **kw)
    lj, _, _, _ = neptpu.nleigs(_scalar_problem(neptpu), S, **kw)
    _same_set(lt, np.asarray(lj))
    for x in lt:
        assert abs(0.2 * np.sqrt(x) - 0.6 * np.sin(2 * x)) < 1e-10
    assert len(lt) >= (3 if rational else 1)
