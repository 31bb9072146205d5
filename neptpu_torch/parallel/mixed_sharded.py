"""Sharded mixed bank + SMW shifted solve: the gun/WEP class on a mesh.

The whole pipeline of :class:`neptpu_torch.ops.mixed.MixedTermBank` (banded
bulk + stacked low-rank factors: boundary terms, arrow borders, complex
parts), row-sharded:

* the DIA bulk is a :class:`~neptpu_torch.parallel.halo.ShardedDiaBank`:
  per apply one halo exchange, overlapped with one kernel-B1 pair launch on
  the rank's block, then the boundary corrections;
* the low-rank factors are row-sharded too: the contraction
  ``u_r = sum_n U[n, r] W[n, tidx_r]`` is a local partial sum, and the four
  groups' partial sums (re/im parts of the real and imaginary factor
  stacks) go in ONE ``psum``; the expansion ``L @ u`` is local;
* the shifted solve is SPIKE on the interleaved-real banded part
  (``parallel/spike.py``) plus a Sherman-Morrison-Woodbury correction for
  the summed low-rank part: per solve one ``all_gather`` of 2b boundary rows
  and one ``psum`` of a 2R vector.

:func:`iar_real_spmf_sharded` runs the complex-as-real IAR in the
theta-scaled Taylor space (as ``neptpu/parallel/mixed_sharded.py:200-243``):
the static-shape sharded step of ``solvers/iar_sharded.py`` with a constant
``1/theta`` block shift, captured once and replayed on an NCCL mesh on the
card (run at one rank only, where no collective is live), eager on a
host-staged mesh and on the CPU.

Not carried over: ``cost_only=`` (``mixed_sharded.py:370-398``), which reads
XLA's compiled cost analysis - TPU/XLA machinery with no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import to_numpy_dtype, to_torch_dtype
from ..core import trace
from ..ops.partitioned import complex_lowrank_to_interleaved
from .halo import ShardedDiaBank, shard_vector
from .spike import SpikeBandedSolver, interleave_complex_banded

__all__ = ["ShardedMixedBank", "iar_real_spmf_sharded"]


class ShardedMixedBank:
    """Row-sharded :class:`~neptpu_torch.ops.mixed.MixedTermBank`: the DIA
    bulk as a :class:`~neptpu_torch.parallel.halo.ShardedDiaBank`, the
    low-rank factor stacks as this rank's ``(blk, R)`` blocks on
    ``mesh.device``."""

    def __init__(self, bank, ndev, mesh, axis="rows"):
        from ..ops.dia import DiaTermBank

        if not isinstance(bank.inner, DiaTermBank):
            raise TypeError(
                "sharded mixed bank needs a DIA (banded) main bank; got "
                f"{type(bank.inner).__name__} — the bulk terms are not "
                "banded/arrow-splittable at this size")
        self.sdia = ShardedDiaBank(bank.inner, ndev).device_put(mesh, axis)
        self.blk = self.sdia.blk
        self.ndev = ndev
        self.n = bank.n
        self.nterms = bank.nterms
        self.main_idx = bank.main_idx
        self.tidx_r, self.tidx_i = bank.tidx_r, bank.tidx_i
        dev = mesh.device
        self._sel = torch.tensor(self.main_idx, device=dev)
        self._tr = torch.tensor(self.tidx_r, dtype=torch.int64, device=dev)
        self._ti = torch.tensor(self.tidx_i, dtype=torch.int64, device=dev)

        def put(x):
            if x is None:
                return None
            return shard_vector(x.cpu().numpy(), mesh, self.blk, axis)

        self.Lr, self.Ur = put(bank.Lr), put(bank.Ur)
        self.Li, self.Ui = put(bank.Li), put(bank.Ui)


def _mixed_lincomb_split_local(sb, WreT, WimT, mesh, axis):
    """This rank's rows of the split-channel mixed Mlincomb for its
    term-major channel blocks ``(nterms, blk)`` in ORIGINAL term order: the
    main terms through the bulk/boundary apply (one exchange, one B1 pair
    launch on the block), the low-rank groups' partial sums in one ``psum``.
    Nothing is read on the host: the term selections are index tensors on
    the device and the split sizes Python ints."""
    zre, zim = sb.sdia.lincomb_pair_t(WreT[sb._sel].contiguous(),
                                      WimT[sb._sel].contiguous(), mesh, axis)
    parts = []
    for U, tidx in ((sb.Ur, sb._tr), (sb.Ui, sb._ti)):
        if U is not None:
            for WT in (WreT, WimT):
                parts.append(torch.sum(U * WT.T[:, tidx], dim=0))
    if not parts:
        return zre, zim
    u = mesh.psum(torch.cat(parts), axis)
    u = list(torch.split(u, [p.shape[0] for p in parts]))
    if sb.Lr is not None:
        ure, uim = u.pop(0), u.pop(0)
        zre = zre + sb.Lr @ ure
        zim = zim + sb.Lr @ uim
    if sb.Li is not None:
        vre, vim = u.pop(0), u.pop(0)
        zre = zre - sb.Li @ vim
        zim = zim + sb.Li @ vre
    return zre, zim


def _smw_solve_local(spike, X_d, Util_d, Kinv, f_d, mesh, axis):
    """Sharded SMW solve on one rank: the SPIKE banded solve and the
    ``psum``'d low-rank correction.  ``f_d``: the interleaved local RHS
    ``(2 blk[, k])``; ``X_d``/``Util_d`` this rank's ``(2 blk, 2R)`` blocks
    of ``B^{-1} Ltil`` and ``Util``; ``Kinv`` the replicated ``(2R, 2R)``
    capacitance inverse."""
    g = spike.solve_sharded(f_d)
    if X_d is None:
        return g
    t = mesh.psum(Util_d.T @ g, axis)
    return g - X_d @ (Kinv @ t)


def _assemble_sigma(mats, fv, sigma):
    """Complex banded strips + stacked complex low-rank factors of
    M(sigma) (host side, exact complex128) — the serial assembly, which keeps
    complex tail diagonals in the BAND (the bank's re/im split would leave
    the banded real part singular for WEP-class problems)."""
    from ..ops.partitioned import assemble_shift_parts

    parts = assemble_shift_parts(mats, fv, sigma)
    if parts is None:
        raise ValueError(
            "M(sigma) bulk is neither banded nor arrow-splittable; the "
            "sharded SPIKE+SMW solve does not apply")
    strips, offs, Lc, Uc = parts
    return strips, tuple(offs), Lc, Uc


def mixed_scan_inputs(mats, fv, mesh, sigma, gamma, m, v, dt, axis):
    """The sharded scan's ``inputs`` (``solvers.iar_sharded.sharded_scan``)
    for an SPMF's terms ``mats``/``fv`` - this rank's mixed-bank block, its
    SPIKE + SMW factors of M(sigma) (timed) and the theta-scaled coefficient
    table - and ``setup``: ``t_factorize``, ``theta``, ``steps`` (m, or the
    table's finite prefix), ``blk``, the SPIKE block and reduced-system
    sizes and the shape of the block B1 applies (``bulk``)."""
    from ..ops.mixed import make_mixed_bank
    from ..solvers.iar_real import apply_theta, auto_theta
    from ..solvers.iar_sharded import pad_sigma_strips
    from ..solvers.spmf_real import (_sync, finite_table_prefix,
                                     spmf_coeff_table)

    n = mats[0].shape[0]
    rdt = to_numpy_dtype(dt)
    ndev, dev = int(mesh.size(axis)), mesh.device

    # the whole bank is built on the host, only this rank's block moves
    bank = make_mixed_bank(mats, dtype=rdt, fmt="dia", device="cpu")
    sbank = ShardedMixedBank(bank, ndev, mesh, axis)
    blk = sbank.blk

    # ---- distributed shifted factorization: SPIKE + SMW ------------------
    with trace.clock("nt.factorize") as fact:
        with trace.span("nt.factorize.assemble"):
            cstrips, coffs, Lc, Uc = _assemble_sigma(mats, fv, sigma)
            cstrips = pad_sigma_strips(cstrips, coffs, ndev * blk)
            rstrips, roffs = interleave_complex_banded(cstrips, coffs)
        spike = SpikeBandedSolver(rstrips, roffs, mesh, axis=axis, dtype=rdt)
        X_d = Util_d = Kinv = None
        if Lc is not None:
            Ltil, Util = complex_lowrank_to_interleaved(Lc, Uc)
            Ltil_d = shard_vector(Ltil.astype(rdt), mesh, 2 * blk, axis)
            Util_d = shard_vector(Util.astype(rdt), mesh, 2 * blk, axis)
            X_d = spike.solve_sharded(Ltil_d)  # (2 blk, 2R)
            K = torch.eye(Util_d.shape[1], dtype=dt, device=dev) + mesh.psum(
                Util_d.T @ X_d, axis)
            Kinv = torch.linalg.inv(K)
        _sync(dev)
    t_fact = fact.seconds

    # ---- coefficient table: the theta-scaled Taylor space only, theta
    # fitted to the per-factorial table envelope
    Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m, scaled=True)
    theta = auto_theta(Cre, Cim, m, dt)
    Cre, Cim = apply_theta(Cre, Cim, theta)
    m = min(m, finite_table_prefix(Cre, Cim, dt))
    Cre, Cim = Cre[:, : m + 1], Cim[:, : m + 1]

    v = np.asarray(np.ones(n) if v is None else v, dtype=complex)
    inputs = (lambda a, b: _mixed_lincomb_split_local(sbank, a, b, mesh, axis),
              lambda f: _smw_solve_local(spike, X_d, Util_d, Kinv, f, mesh,
                                         axis),
              torch.as_tensor(Cre, dtype=dt, device=dev),
              torch.as_tensor(Cim, dtype=dt, device=dev), 0.0, 0.0,
              torch.full((m + 1,), 1.0 / theta, dtype=dt, device=dev),
              shard_vector(v.real, mesh, blk, axis).to(dt),
              shard_vector(v.imag, mesh, blk, axis).to(dt))
    setup = {"t_factorize": t_fact, "theta": theta, "steps": m, "blk": blk,
             "spike_block": spike.blk, "reduced": spike.reduced_size,
             "bulk": tuple(sbank.sdia.data.shape)}
    return inputs, setup


def iar_real_spmf_sharded(nep, mesh, sigma=0.0, gamma=1.0, maxit=30,
                          neigs=6, tol=None, v=None, dtype=torch.float64,
                          axis="rows", errmeasure=None, return_info=False):
    """Distributed complex-as-real IAR on a mixed-bank SPMF (gun/WEP class).

    Same contract as :func:`neptpu_torch.solvers.spmf_real.iar_real_spmf`
    with ``scaled=True``, with basis, Mlincomb, orthogonalization and the
    SPIKE+SMW shifted solve row-sharded over ``mesh``'s ``axis``; every rank
    calls it with the same arguments and gets the same ``(lams, Q)``
    (numpy).  ``info`` as :func:`~neptpu_torch.solvers.iar_sharded.
    iar_real_sharded`'s, with ``theta`` and ``steps`` (m, or the table's
    finite prefix).  The JAX package's ``cost_only`` (XLA's cost analysis)
    is not carried over."""
    from ..solvers.iar_real import _hessenberg
    from ..solvers.iar_sharded import (ritz_from_sharded, select_converged,
                                       sharded_scan)
    from ..solvers.spmf_real import _spmf_host_resnorm, collect_spmf_terms

    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)

    inputs, setup = mixed_scan_inputs(mats, fv, mesh, sigma, gamma,
                                      int(maxit), v, dt, axis)
    m = setup["steps"]
    with trace.clock("nt.scan") as scan:
        carry, graph = sharded_scan(m, inputs, mesh, axis)
    t_scan = scan.seconds

    lams, Q = ritz_from_sharded(*carry, m, n, sigma, gamma, mesh, axis)
    rn = errmeasure if errmeasure is not None else _spmf_host_resnorm(mats, fv)
    take, nconv, errs = select_converged(lams, Q, rn, tol, neigs)
    info = dict(setup, t_scan=t_scan, nconv=nconv, errs=errs,
                ndev=int(mesh.size(axis)), graph=graph,
                hessenberg=_hessenberg(carry))
    if return_info:
        return lams[take], Q[:, take], info
    return lams[take], Q[:, take]
