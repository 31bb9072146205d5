"""Port parity: the contour-integral solvers (Beyn, block-SS in both
``Shat_mode``s), the batched shifted solves behind them, the quadrature
helpers and the distributed-delay problem, in
complex128 on the CPU.  Eigenvalues to rel 1e-10 of the JAX package's (as
sets), the solves and quadratures elementwise to 1e-12."""
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, gallery_pair, small_gun_like

import neptpu
import neptpu_torch as nt
from neptpu.models.gallery.distributed import DEP_DISTRIBUTED_EIGENVALUES
from neptpu_torch.solvers import contour

REL = 1e-10


def _same_set(a, b, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), (a, b)
    for x in a:
        assert np.min(np.abs(b - x)) <= rel * abs(x), (x, b)
    for x in b:
        assert np.min(np.abs(a - x)) <= rel * abs(x), (x, a)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


@pytest.fixture(scope="module")
def distributed():
    return gallery_pair("dep_distributed")


def test_dep_distributed_matches(distributed):
    """The port's problem equals the JAX package's at several points and is
    singular at the published eigenvalues; the two quadratures of its
    kernel agree with the JAX package's."""
    tn, jn = distributed
    from neptpu.models.gallery import distributed as jd
    from neptpu_torch.models.gallery import distributed as td

    for lam in (0.3 + 0.1j, -1.0 + 2j, DEP_DISTRIBUTED_EIGENVALUES[3]):
        _close(tn.Mder_dense(lam).numpy(), np.asarray(jn.Mder_dense(lam)))
        _close(tn.Mder_dense(lam, 1).numpy(),
               np.asarray(jn.Mder_dense(lam, 1)), 1e-10)
    for lam in DEP_DISTRIBUTED_EIGENVALUES:
        assert np.linalg.svd(tn.Mder_dense(lam).numpy(),
                             compute_uv=False)[-1] < 1e-9
    S = np.array([[0.3, 0.1], [-0.2, 0.5]]) + 0j
    # the kernels chain 10 and 1001 matrix exponentials, which the two
    # packages' expm round differently: 1e-11
    for fn in ("distributed_kernel_gauss_legendre",
               "distributed_kernel_trapezoidal"):
        _close(getattr(td, fn)(torch.as_tensor(S)).numpy(),
               np.asarray(getattr(jd, fn)(S)), 1e-11)
        _close(complex(getattr(td, fn)(torch.tensor(
            0.4 + 0.1j, dtype=torch.complex128))),
               complex(getattr(jd, fn)(0.4 + 0.1j)), 1e-11)


@pytest.mark.parametrize("integrator", ["trapezoidal", "gauss_legendre"])
def test_integrate_interval_matches(integrator):
    f = lambda t: np.array([[np.cos(t), np.sin(2 * t)]])
    gv = [lambda s: 1.0, lambda s: np.cos(s)]
    name = ("MatrixTrapezoidal" if integrator == "trapezoidal"
            else "MatrixGaussLegendre")
    St = nt.integrate_interval(getattr(nt, name), complex, f, gv, 0,
                               2 * np.pi, 60)
    Sj = neptpu.integrate_interval(getattr(neptpu, name), complex, f, gv, 0,
                                   2 * np.pi, 60)
    _close(St, Sj)
    assert abs(St[0, 0, 1] - np.pi) < 1e-10
    # a tensor integrand gives a tensor
    Tt = nt.integrate_interval(getattr(nt, name), complex,
                               lambda t: torch.as_tensor(f(t)), gv, 0,
                               2 * np.pi, 60)
    assert isinstance(Tt, torch.Tensor)
    _close(Tt.numpy(), Sj)


def test_batched_shifted_solves_match():
    tn, jn = gallery_pair("dep0")
    shifts = -0.16 + 0.3 * np.exp(2j * np.pi * np.arange(10) / 10)
    Vh = np.random.default_rng(1).standard_normal((5, 2)) + 0j
    contour.BATCHED_LU.update(chunks=0, nodes=0)
    Yt = nt.batched_shifted_solves(tn, shifts, torch.as_tensor(Vh), chunk=4)
    Yj = neptpu.batched_shifted_solves(jn, shifts, Vh, chunk=4)
    assert contour.BATCHED_LU == {"chunks": 3, "nodes": 10}
    _close(Yt.numpy(), np.asarray(Yj))


def test_contour_beyn_dep_distributed(distributed):
    tn, jn = distributed
    kw = dict(sigma=0.0, radius=1.5, neigs=2, N=64, k=3, sanity_check=False)
    lt, Vt = nt.contour_beyn(tn, device=CPU, **kw)
    lj, Vj = neptpu.contour_beyn(jn, **kw)
    _same_set(lt, np.asarray(lj))
    _same_set(lt[:2], DEP_DISTRIBUTED_EIGENVALUES[:2], rel=1e-6)
    for i in range(2):
        assert float(nt.compute_resnorm(tn, lt[i], Vt[:, i])) < 1e-6


def test_contour_beyn_checked_and_mesh(distributed):
    """The default ``sanity_check`` path (errors measured, eigenvalues
    outside the contour last), and ``mesh=`` (the node axis over the ranks
    of a mesh) on a one-rank gloo mesh equal to the serial result."""
    import torch.distributed as dist

    from neptpu_torch.parallel import make_mesh

    tn, jn = distributed
    kw = dict(sigma=0.0, radius=1.5, neigs=2, N=64, k=3)
    lt, Vt = nt.contour_beyn(tn, device=CPU, **kw)
    lj, _ = neptpu.contour_beyn(jn, **kw)
    _same_set(lt, np.asarray(lj))
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(rows=1, nodes=1, device=CPU, backend="gloo")
        assert mesh.backend == "gloo" and not mesh.host_staged
        lm, Vm = nt.contour_beyn(tn, device=CPU, mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    _same_set(lm, lt, rel=1e-12)
    _close(torch.abs(Vm), torch.abs(Vt))


def test_contour_beyn_batched_equals_loop():
    """The batched shifted-solve path equals the per-node integrator loop,
    and both the JAX package's."""
    tn, jn = gallery_pair("dep0")
    kw = dict(sigma=-0.16, radius=0.3, neigs=1, N=50, k=2,
              sanity_check=False)
    l1, _ = nt.contour_beyn(tn, device=CPU, **kw)
    l2, _ = nt.contour_beyn(tn, device=CPU, integrator=nt.MatrixTrapezoidal,
                            **kw)
    lj, _ = neptpu.contour_beyn(jn, **kw)
    assert abs(l1[0] - l2[0]) <= REL * abs(l2[0])
    assert abs(l1[0] - np.asarray(lj)[0]) <= REL * abs(l1[0])
    assert abs(l1[0] - (-0.15955391823299267)) < 1e-8


def test_batched_path_errors_propagate():
    """An error inside the batched path reaches the caller: the port falls
    back to the per-node loop only for a problem without a dense Mder."""
    tn, _ = gallery_pair("dep0")

    class Broken(type(tn)):
        def Mder_dense(self, lam, der=0):
            raise RuntimeError("device error")

    bad = Broken(None, tn.tauv, bank=tn.bank)
    with pytest.raises(RuntimeError, match="device error"):
        nt.contour_beyn(bad, sigma=-0.16, radius=0.3, neigs=1, N=8, k=2,
                        sanity_check=False, device=CPU)


def test_contour_block_SS_native(distributed):
    tn, jn = distributed
    kw = dict(sigma=0.0, radius=1.5, k=2, K=2, N=64)
    lt, Vt = nt.contour_block_SS(tn, device=CPU, **kw)
    lj, _ = neptpu.contour_block_SS(jn, **kw)
    _same_set(lt, np.asarray(lj))
    for t in DEP_DISTRIBUTED_EIGENVALUES[:2]:
        assert np.min(np.abs(lt - t)) < 1e-6
    assert isinstance(Vt, torch.Tensor) and Vt.shape[1] == len(lt)


def test_contour_block_SS_jsiam():
    tn, jn = gallery_pair("dep0")
    kw = dict(sigma=-0.1, radius=0.3, k=2, K=2, N=64, Shat_mode=":JSIAM")
    lt, _ = nt.contour_block_SS(tn, device=CPU, **kw)
    lj, _ = neptpu.contour_block_SS(jn, **kw)
    _same_set(lt, np.asarray(lj))
    assert np.min(np.abs(lt - (-0.15955391823299267))) < 1e-6
    with pytest.raises(ValueError, match="ellipses"):
        nt.contour_block_SS(tn, device=CPU, **dict(kw, radius=(0.3, 0.2)))


@pytest.fixture(scope="module")
def small_gun():
    """The gun structure at n = 576 (K times 4: a spectrum past the second
    branch point, as gun_like's target is)."""
    from neptpu.models.gallery.nlevp import _gun_from_matrices as jgun
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices as tgun

    K, M, W1, W2 = small_gun_like()
    K = (4 * K).tocsr()
    return tgun(K, M, W1, W2, device=CPU), jgun(K, M, W1, W2)


def test_contour_gun_structured(small_gun):
    """Beyn and block-SS on an ellipse holding five eigenvalues of the
    gun-structured problem: the same eigenvalues, each the JAX package's
    (Beyn) within rel 1e-10, and block-SS's within rel 1e-10 of Beyn's."""
    tn, jn = small_gun
    kw = dict(sigma=14960 + 1.5j, radius=(45.0, 10.0), N=64, chunk=8)
    lt, Vt = nt.contour_beyn(tn, neigs=6, k=8, device=CPU,
                             errmeasure=nt.StandardSPMFErrmeasure, **kw)
    lj, _ = neptpu.contour_beyn(jn, neigs=6, k=8,
                                errmeasure=neptpu.StandardSPMFErrmeasure, **kw)
    assert len(lt) == 5
    _same_set(lt, np.asarray(lj))
    ls, _ = nt.contour_block_SS(tn, k=4, K=4, device=CPU, **kw)
    _same_set(ls, lt)
