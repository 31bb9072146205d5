"""Fully sharded complex-as-real IAR on a banded delay problem.

Every length-n object (Krylov basis blocks, Mlincomb operands, the shifted
solve) lives row-sharded over the mesh's ``rows`` axis: a rank holds its
``(m+1, m+1, blk)`` basis pair and its bank window, so per-rank memory is
``O((m+1)^2 n / ndev)``.  Per IAR step a rank does:

* one halo exchange of the re/im operand strips and ONE kernel-B1 pair
  launch on its window (``parallel/halo.py``);
* one SPIKE shifted solve (``parallel/spike.py``): a local LU solve, one
  ``all_gather`` of 2b boundary rows, the replicated reduced solve;
* the two-pass DGKS with its Gram products ``psum``'d (three ``psum``\\ s a
  step: one per pass for the re/im pair of Gram vectors, one for the norm).

The JAX package compiles the m steps into one ``shard_map``-wrapped
``lax.scan``; here every rank runs the same eager loop of m steps, as the
port's serial ``iar_real`` does, and the math is that scan's
(``neptpu/solvers/iar_sharded.py:93-147``).  The Ritz extraction runs on the
host of every rank from the all-gathered first basis block, so every rank
returns the same eigenvalues and the full ``Q``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import to_numpy_dtype, to_torch_dtype
from ..parallel.halo import ShardedDiaBank, shard_vector
from ..parallel.spike import SpikeBandedSolver, interleave_complex_banded
from .iar_real import _dep_host_resnorm, dep_coeff_table
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


def sharded_scan(m, apply_pair, solve, Cre, Cim, gre, gim, shift, v0re,
                 v0im, mesh, axis):
    """m complex-as-real IAR steps on this rank's blocks.

    ``apply_pair(WreT, WimT) -> (zre, zim)``: the sharded bank apply of the
    term-major channels ``(terms, blk)``; ``solve(f) -> x``: the sharded
    shifted solve of an interleaved ``(2 blk,)`` RHS; ``gre``/``gim``: the
    identity term's coefficient (``-gamma y_1``); ``shift(k)``: the block
    shift's row factors ``(k,)`` (``1/(j+1)``, or ``1/theta`` in the scaled
    space).  Returns ``(Vre, Vim, Hre, Him)``: this rank's basis pair
    ``(m+1, m+1, blk)`` and the replicated Hessenberg pair ``(m+1, m)``."""
    blk, dt, dev = v0re.shape[0], v0re.dtype, v0re.device
    nrm0 = torch.sqrt(mesh.psum(torch.sum(v0re**2) + torch.sum(v0im**2),
                                axis))
    Vre = torch.zeros((m + 1, m + 1, blk), dtype=dt, device=dev)
    Vim = torch.zeros_like(Vre)
    Vre[0, 0] = v0re / nrm0
    Vim[0, 0] = v0im / nrm0
    Hre = torch.zeros((m + 1, m), dtype=dt, device=dev)
    Him = torch.zeros_like(Hre)
    jblk = torch.arange(m + 1, device=dev)
    VreM = Vre.view(m + 1, -1)
    VimM = Vim.view(m + 1, -1)
    for k in range(1, m + 1):
        sj = shift(k)
        ytre = torch.zeros((m + 1, blk), dtype=dt, device=dev)
        ytim = torch.zeros_like(ytre)
        ytre[1:k + 1] = Vre[k - 1, :k] * sj[:, None]
        ytim[1:k + 1] = Vim[k - 1, :k] * sj[:, None]
        WreT = Cre @ ytre - Cim @ ytim  # (terms, blk)
        WimT = Cre @ ytim + Cim @ ytre
        zre, zim = apply_pair(WreT, WimT)
        zre, zim = zre.to(dt), zim.to(dt)
        zre = zre - gre * ytre[1] + gim * ytim[1]
        zim = zim - gre * ytim[1] - gim * ytre[1]
        sol = solve(torch.stack([zre, zim], dim=1).reshape(-1))
        ytre[0] = -sol[0::2]
        ytim[0] = -sol[1::2]

        # DGKS (two-pass CGS), the re/im Gram vectors psum'd together
        wre, wim = ytre.reshape(-1), ytim.reshape(-1)

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
        Vre[k] = (wre / beta).reshape(m + 1, blk)
        Vim[k] = (wim / beta).reshape(m + 1, blk)
        Hre[:, k - 1] = torch.where(jblk == k, beta, hre)
        Him[:, k - 1] = torch.where(jblk == k, torch.zeros_like(him), him)
    return Vre, Vim, Hre, Him


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


def iar_real_sharded(nep, mesh, sigma=0.0, gamma=1.0, maxit=30, neigs=6,
                     tol=None, v=None, dtype=torch.float64,
                     axis: str = "rows", return_info=False):
    """Distributed complex-as-real IAR on a banded DEP.

    Same contract as :func:`neptpu_torch.solvers.iar_real.iar_real`, with the
    Krylov basis, Mlincomb, orthogonalization and the shifted direct solve
    row-sharded over ``mesh``'s ``axis``; every rank calls it with the same
    arguments and gets the same ``(lams, Q)`` (numpy).  ``info`` adds the
    factorization and scan times, the SPIKE block and reduced-system sizes
    and the B1 window's shape."""
    n = nep.n
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    ndev = int(mesh.size(axis))
    dev = mesh.device

    sbank = ShardedDiaBank(nep.bank, ndev).device_put(mesh, axis, dtype=dt)
    blk = sbank.blk

    # distributed shifted factorization (SPIKE on the interleaved real form)
    t0 = time.perf_counter()
    cstrips, coffs = dep_sigma_strips(nep, sigma)
    cstrips = pad_sigma_strips(cstrips, coffs, ndev * blk)
    rstrips, roffs = interleave_complex_banded(cstrips, coffs)
    spike = SpikeBandedSolver(rstrips, roffs, mesh, axis=axis,
                              dtype=to_numpy_dtype(dt))
    _sync(dev)
    t_fact = time.perf_counter() - t0

    Cre, Cim = dep_coeff_table(nep, sigma, gamma, m)
    if v is None:
        v = np.ones(n)
    v = np.asarray(v, dtype=complex)
    v0re = shard_vector(v.real, mesh, blk, axis).to(dt)
    v0im = shard_vector(v.imag, mesh, blk, axis).to(dt)

    t0 = time.perf_counter()
    Vre, Vim, Hre, Him = sharded_scan(
        m, lambda a, b: sbank.lincomb_pair_t(a, b, mesh, axis),
        spike.solve_sharded,
        torch.as_tensor(Cre, dtype=dt, device=dev),
        torch.as_tensor(Cim, dtype=dt, device=dev),
        float(np.real(gamma)), float(np.imag(gamma)),
        lambda k: 1.0 / torch.arange(1, k + 1, dtype=dt, device=dev),
        v0re, v0im, mesh, axis)
    _sync(dev)
    t_scan = time.perf_counter() - t0

    lams, Q = ritz_from_sharded(Vre, Vim, Hre, Him, m, n, sigma, gamma,
                                mesh, axis)
    take, nconv, errs = select_converged(lams, Q, _dep_host_resnorm(nep),
                                         tol, neigs)
    info = {"t_factorize": t_fact, "t_scan": t_scan, "nconv": nconv,
            "errs": errs, "ndev": ndev, "blk": blk,
            "spike_block": spike.blk, "reduced": spike.reduced_size,
            "window": tuple(sbank.window.data.shape)}
    if return_info:
        return lams[take], Q[:, take], info
    return lams[take], Q[:, take]
