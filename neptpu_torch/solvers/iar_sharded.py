"""Fully sharded complex-as-real IAR on a banded delay problem.

Every length-n object (Krylov basis blocks, Mlincomb operands, the shifted
solve) lives row-sharded over the mesh's ``rows`` axis: a rank holds its
``(m+1, m+1, blk)`` basis pair and its bank block, so per-rank memory is
``O((m+1)^2 n / ndev)``.  Per IAR step a rank does:

* one halo exchange of the re/im operand strips, overlapped with ONE
  kernel-B1 pair launch on its block, then the boundary corrections
  (``parallel/halo.py``);
* one SPIKE shifted solve (``parallel/spike.py``): a local LU solve, one
  ``all_gather`` of 2b boundary rows, the replicated reduced solve;
* the two-pass DGKS with its Gram products ``psum``'d (three ``psum``\\ s a
  step: one per pass for the re/im pair of Gram vectors, one for the norm).

The step is the JAX scan's body (``neptpu/solvers/iar_sharded.py:93-143``)
in its static-shape form: the step index ``k`` a 0-dim int64 tensor on the
mesh's device, the block shift a ``(m+1,)`` row-factor vector masked by
``jblk < k`` and rolled by one block, the carry written in place by index
ops.  Where the JAX package compiles the m steps into one
``shard_map``-wrapped ``lax.scan``, every rank runs them through
:class:`~neptpu_torch.solvers.scan_graph.StepGraph`: on a CUDA mesh whose
collectives run on the card (NCCL) the step is captured once and replayed
(at one NCCL rank the collectives return at once, so the captured step
holds none; a capture whose step exchanges strips between two or more
ranks has not been run); on a host-staged mesh (gloo over CUDA tensors:
every collective goes through the host) and on the CPU the same step runs
eagerly, decided from ``mesh.host_staged`` before the scan starts.  The
Ritz extraction runs on the host of every rank from the all-gathered first
basis block, so every rank returns the same eigenvalues and the full ``Q``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import to_numpy_dtype, to_torch_dtype
from ..core import trace
from ..parallel.halo import ShardedDiaBank, shard_vector
from ..parallel.spike import SpikeBandedSolver, interleave_complex_banded
from .iar_real import _dep_host_resnorm, _hessenberg, dep_coeff_table
from .scan_graph import StepGraph
from .spmf_real import _sync

__all__ = ["iar_real_sharded", "dep_sigma_strips"]


def dep_sigma_strips(nep, sigma):
    """Complex diagonal strips of ``M(sigma) = -sigma I + sum_i A_i
    e^{-tau_i sigma}`` for a DEP over a DiaTermBank (host numpy,
    O(ndiag n))."""
    bank = nep.bank
    tau = np.asarray(nep.tauv, dtype=float)
    w = np.exp(-tau * complex(sigma))
    data = (bank._host_data if bank._host_data is not None
            else bank.data.cpu().numpy())
    strips = np.tensordot(w, data.astype(complex), axes=1)  # (ndiag, n)
    offsets = list(bank.offsets)
    if 0 in offsets:
        strips[offsets.index(0)] -= complex(sigma)
    else:
        extra = np.full((1, strips.shape[1]), -complex(sigma))
        strips = np.concatenate([strips, extra], axis=0)
        offsets = offsets + [0]
    return strips, tuple(offsets)


def pad_sigma_strips(cstrips, coffs, total):
    """Complex strips zero-padded to ``total`` rows with an identity on the
    padded tail (the sharded length)."""
    if cstrips.shape[1] >= total:
        return cstrips
    padc = np.zeros((cstrips.shape[0], total), dtype=cstrips.dtype)
    padc[:, : cstrips.shape[1]] = cstrips
    padc[coffs.index(0), cstrips.shape[1]:] = 1.0
    return padc


def sharded_step_fn(m, apply_pair, solve, Cre, Cim, gre, gim, sj, mesh,
                    axis):
    """One sharded complex-as-real IAR step as ``step(carry, k)`` (the
    JAX scan's ``step``): ``k`` the 1-based step index, a 0-dim int64 tensor
    on the carry's device; the carry ``(Vre, Vim, Hre, Him)`` - this rank's
    basis pair ``(m+1, m+1, blk)`` and the replicated Hessenberg pair
    ``(m+1, m)`` - is updated in place.  Every shape is static and nothing
    is read on the host.

    ``apply_pair(WreT, WimT) -> (zre, zim)``: the sharded bank apply of the
    term-major channels ``(terms, blk)``; ``solve(f) -> x``: the sharded
    shifted solve of an interleaved ``(2 blk,)`` RHS; ``gre``/``gim``: the
    identity term's coefficient (``-gamma y_1``); ``sj (m+1,)``: the block
    shift's row factors (``1/(j+1)``, or ``1/theta`` in the scaled
    space)."""
    dev, dt = Cre.device, Cre.dtype
    jblk = torch.arange(m + 1, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def step(carry, k):
        Vre, Vim, Hre, Him = carry
        km1 = (k - 1).view(1)
        # block shift of the last basis vector: row j+1 of y = s_j V[k-1][j]
        # for j < k (row 0 is filled by the solve below)
        scale = torch.where(jblk < k, sj, zero)[:, None]
        ytre = torch.roll(Vre.index_select(0, km1)[0] * scale, 1, 0)
        ytim = torch.roll(Vim.index_select(0, km1)[0] * scale, 1, 0)
        WreT = Cre @ ytre - Cim @ ytim  # (terms, blk)
        WimT = Cre @ ytim + Cim @ ytre
        zre, zim = apply_pair(WreT, WimT)
        zre, zim = zre.to(dt), zim.to(dt)
        if gre or gim:  # identity term: -gamma * y_1
            zre = zre - gre * ytre[1] + gim * ytim[1]
            zim = zim - gre * ytim[1] - gim * ytre[1]
        sol = solve(torch.stack([zre, zim], dim=1).reshape(-1))
        ytre[0] = -sol[0::2]
        ytim[0] = -sol[1::2]

        # DGKS (two-pass CGS), the re/im Gram vectors psum'd together
        wre, wim = ytre.reshape(-1), ytim.reshape(-1)
        VreM = Vre.reshape(m + 1, -1)
        VimM = Vim.reshape(m + 1, -1)

        def cgs(wre, wim):
            h = mesh.psum(torch.cat([VreM @ wre + VimM @ wim,
                                     VreM @ wim - VimM @ wre]), axis)
            hre, him = h[: m + 1], h[m + 1:]
            wre = wre - (VreM.T @ hre - VimM.T @ him)
            wim = wim - (VreM.T @ him + VimM.T @ hre)
            return wre, wim, hre, him

        wre, wim, h1re, h1im = cgs(wre, wim)
        wre, wim, h2re, h2im = cgs(wre, wim)
        hre, him = h1re + h2re, h1im + h2im
        beta = torch.sqrt(mesh.psum(torch.sum(wre**2) + torch.sum(wim**2),
                                    axis))
        kk = k.view(1)
        Vre.index_copy_(0, kk, (wre / beta).reshape(1, m + 1, -1))
        Vim.index_copy_(0, kk, (wim / beta).reshape(1, m + 1, -1))
        top = jblk == k
        Hre.index_copy_(1, km1, torch.where(top, beta, hre)[:, None])
        Him.index_copy_(1, km1, torch.where(top, zero, him)[:, None])
        return beta

    return step


def sharded_carry(m, v0re, v0im, mesh, axis):
    """The scan's start carry ``(Vre, Vim, Hre, Him)``: this rank's zero
    basis pair ``(m+1, m+1, blk)`` with the unit start vector (its norm
    psum'd) in slot (0, 0), and a zero Hessenberg pair ``(m+1, m)``."""
    blk, dt, dev = v0re.shape[0], v0re.dtype, v0re.device
    nrm0 = torch.sqrt(mesh.psum(torch.sum(v0re**2) + torch.sum(v0im**2),
                                axis))
    Vre = torch.zeros((m + 1, m + 1, blk), dtype=dt, device=dev)
    Vim = torch.zeros_like(Vre)
    Vre[0, 0] = v0re / nrm0
    Vim[0, 0] = v0im / nrm0
    Hre = torch.zeros((m + 1, m), dtype=dt, device=dev)
    return (Vre, Vim, Hre, torch.zeros_like(Hre))


def sharded_scan(m, inputs, mesh, axis):
    """m sharded IAR steps (:func:`sharded_step_fn`) on this rank's blocks.
    ``inputs``: ``(apply_pair, solve, Cre, Cim, gre, gim, sj, v0re, v0im)``,
    the step's operands and the start vector pair.  Returns ``(carry,
    graph)``: the carry ``(Vre, Vim, Hre, Him)`` and how the steps ran
    (``StepGraph.stats()`` and ``why``: None where they were replayed as a
    captured graph, else ``"host-staged"``, ``"cpu"`` or ``"eager
    comparator"``).  The steps have run on the device when it returns."""
    carry = sharded_carry(m, *inputs[7:], mesh, axis)
    step = sharded_step_fn(m, *inputs[:7], mesh, axis)
    dev = carry[0].device
    k = torch.ones((), dtype=torch.int64, device=dev)
    with StepGraph(step, carry, k,
                   capturable=not mesh.host_staged) as run:
        run.advance(m)
        run.wait()
    graph = run.stats()
    graph["why"] = (None if run.graphed else "host-staged"
                    if mesh.host_staged else "cpu" if dev.type == "cpu"
                    else "eager comparator")
    return carry, graph


def ritz_from_sharded(Vre, Vim, Hre, Him, m, n, sigma, gamma, mesh, axis):
    """Host Ritz extraction as the serial scan's: ``lams = sigma + gamma /
    eig(H)``, ``Q`` the unit Ritz vectors from the all-gathered first basis
    block (the same on every rank)."""
    Hre_h = Hre.cpu().numpy().astype(np.float64)
    Him_h = Him.cpu().numpy().astype(np.float64)
    H = Hre_h[:m, :m] + 1j * Him_h[:m, :m]
    D, Z = np.linalg.eig(H)
    lams = complex(sigma) + complex(gamma) / D
    V0re = mesh.all_gather(Vre[:, 0, :], axis).cpu().numpy()
    V0im = mesh.all_gather(Vim[:, 0, :], axis).cpu().numpy()
    V0 = (V0re.astype(np.float64) + 1j * V0im.astype(np.float64))
    V0 = V0.transpose(1, 0, 2).reshape(m + 1, -1)[:, :n].T
    Q = V0[:, :m] @ Z
    Q = Q / np.linalg.norm(Q, axis=0, keepdims=True)
    return lams, Q


def select_converged(lams, Q, resnorm, tol, neigs):
    """Residuals of every Ritz pair; the converged ones, residual-sorted."""
    errs = np.array([resnorm(lams[s], Q[:, s]) for s in range(len(lams))])
    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol))
    take = idx[: min(neigs, nconv)]
    return take, nconv, errs[idx]


def dep_scan_inputs(nep, mesh, sigma, gamma, m, v, dt, axis):
    """The sharded scan's ``inputs`` (:func:`sharded_scan`) for a banded
    DEP - this rank's bank block, its SPIKE factors of M(sigma) (timed) and
    the coefficient table - and ``setup``: ``t_factorize``, ``blk``, the
    SPIKE block and reduced-system sizes and the shape of the block B1
    applies (``bulk``)."""
    ndev, dev = int(mesh.size(axis)), mesh.device
    sbank = ShardedDiaBank(nep.bank, ndev).device_put(mesh, axis, dtype=dt)
    blk = sbank.blk

    # distributed shifted factorization (SPIKE on the interleaved real form)
    with trace.clock("nt.factorize") as fact:
        with trace.span("nt.factorize.assemble"):
            cstrips, coffs = dep_sigma_strips(nep, sigma)
            cstrips = pad_sigma_strips(cstrips, coffs, ndev * blk)
            rstrips, roffs = interleave_complex_banded(cstrips, coffs)
        spike = SpikeBandedSolver(rstrips, roffs, mesh, axis=axis,
                                  dtype=to_numpy_dtype(dt))
        _sync(dev)
    t_fact = fact.seconds

    Cre, Cim = dep_coeff_table(nep, sigma, gamma, m)
    v = np.asarray(np.ones(nep.n) if v is None else v, dtype=complex)
    inputs = (lambda a, b: sbank.lincomb_pair_t(a, b, mesh, axis),
              spike.solve_sharded,
              torch.as_tensor(Cre, dtype=dt, device=dev),
              torch.as_tensor(Cim, dtype=dt, device=dev),
              float(np.real(gamma)), float(np.imag(gamma)),
              (1.0 / torch.arange(1, m + 2, dtype=torch.float64,
                                  device=dev)).to(dt),
              shard_vector(v.real, mesh, blk, axis).to(dt),
              shard_vector(v.imag, mesh, blk, axis).to(dt))
    setup = {"t_factorize": t_fact, "blk": blk, "spike_block": spike.blk,
             "reduced": spike.reduced_size, "bulk": tuple(sbank.data.shape)}
    return inputs, setup


def iar_real_sharded(nep, mesh, sigma=0.0, gamma=1.0, maxit=30, neigs=6,
                     tol=None, v=None, dtype=torch.float64,
                     axis: str = "rows", return_info=False):
    """Distributed complex-as-real IAR on a banded DEP.

    Same contract as :func:`neptpu_torch.solvers.iar_real.iar_real`, with the
    Krylov basis, Mlincomb, orthogonalization and the shifted direct solve
    row-sharded over ``mesh``'s ``axis``; every rank calls it with the same
    arguments and gets the same ``(lams, Q)`` (numpy).  ``info`` adds the
    factorization and scan times, the SPIKE block and reduced-system sizes,
    the shape of the block B1 applies (``bulk``), how the steps ran
    (``graph``: :func:`sharded_scan`'s) and the final Hessenberg
    (``hessenberg``, complex128 on the host)."""
    n = nep.n
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    ndev = int(mesh.size(axis))

    inputs, setup = dep_scan_inputs(nep, mesh, sigma, gamma, m, v, dt, axis)
    with trace.clock("nt.scan") as scan:
        carry, graph = sharded_scan(m, inputs, mesh, axis)
    t_scan = scan.seconds

    lams, Q = ritz_from_sharded(*carry, m, n, sigma, gamma, mesh, axis)
    take, nconv, errs = select_converged(lams, Q, _dep_host_resnorm(nep),
                                         tol, neigs)
    info = dict(setup, t_scan=t_scan, nconv=nconv, errs=errs, ndev=ndev,
                graph=graph, hessenberg=_hessenberg(carry))
    if return_info:
        return lams[take], Q[:, take], info
    return lams[take], Q[:, take]
