"""The system under test, built from a configuration file: the port's
gallery problem and the term bank its scans reuse for every shift, as a
user sweeping shifts would hold them.

``kind`` says how the port is driven:

* ``spmf``: a sum of products of matrices and functions (the gun class).
  The scan entry takes the prebuilt mixed term bank as ``bank=``; the
  refinement takes the problem's host term matrices and functions.
* ``dep``: a delay problem whose own term bank is rebuilt once in the scan's
  dtype (``benchmarks/time_to_tol.py``'s problem); the entry takes the
  ``DEP`` itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Problem:
    nep: object
    dtype: object            # the scan's torch dtype
    entry_kwargs: dict
    b1_shape: tuple          # (n, terms, diagonals) of the bank kernel B1 applies
    mats: list = field(default_factory=list)
    fv: list = field(default_factory=list)


def build(cfg, device):
    import torch

    import neptpu_torch as nt
    from neptpu_torch.ops.dia import DiaTermBank
    from neptpu_torch.ops.mixed import make_mixed_bank
    from neptpu_torch.solvers.spmf_real import collect_spmf_terms

    dt = np.dtype(cfg["scan_dtype"])
    tdt = getattr(torch, cfg["scan_dtype"])
    nep = nt.nep_gallery(cfg["gallery"], *cfg.get("gallery_args", []),
                         device=device)
    if cfg["kind"] == "spmf":
        mats, fv = collect_spmf_terms(nep)
        bank = make_mixed_bank(mats, dtype=dt, device=device)
        inner = bank.inner
        return Problem(nep, tdt, {"bank": bank}, _shape(inner), mats, fv)
    if cfg["kind"] == "dep":
        bank = DiaTermBank.from_matrices(nep.bank.host_csr_terms(), dtype=dt,
                                         device=device)
        dep = nt.DEP(None, tauv=nep.tauv, bank=bank)
        return Problem(dep, tdt, {}, _shape(bank))
    raise ValueError(f"unknown problem kind {cfg['kind']!r}")


def _shape(bank):
    """(n, terms, diagonals) of a DIA bank; None for a bank of another
    storage, which kernel B1 does not apply."""
    if not hasattr(bank, "offsets"):
        return None
    m, ndiag, n = bank.data.shape
    return (int(n), int(m), int(ndiag))


def rounded_shift_solver(problem, sigma, dtype, device, round_to):
    """For the correctness control: the program's own shifted solver at
    ``sigma`` (SPIKE + SMW, or the dense block LU), built from the term
    matrices with their values rounded to ``round_to`` (a torch dtype), so
    that every scan step solves with M(sigma) known only to that
    precision.  The scan takes it as its ``lu_piv``."""
    import torch

    from neptpu_torch.ops.partitioned import build_spmf_shift_solver
    from neptpu_torch.solvers.iar_real import dep_shift_block_lu
    from neptpu_torch.solvers.spmf_real import spmf_shift_block_lu

    def rounded(A):
        A = A.tocsr(copy=True).astype(np.float64)
        A.data = torch.from_numpy(A.data).to(round_to).double().numpy()
        return A

    if problem.mats:
        mats = [rounded(A) for A in problem.mats]
        solver = build_spmf_shift_solver(mats, problem.fv, sigma, dtype=dtype,
                                         device=device)
        return solver if solver is not None else spmf_shift_block_lu(
            mats, problem.fv, sigma, dtype=dtype, device=device)
    import neptpu_torch as nt
    from neptpu_torch.ops.dia import DiaTermBank

    nep = problem.nep
    bank = DiaTermBank.from_matrices(
        [rounded(A) for A in nep.bank.host_csr_terms()], dtype=np.float64,
        device=device)
    return dep_shift_block_lu(nt.DEP(None, tauv=nep.tauv, bank=bank), sigma,
                              dtype=dtype, device=device)
