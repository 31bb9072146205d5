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
* ``protocol``: the gallery problem as ``nep_gallery`` builds it, reached
  only through the compute-function protocol (``Mder``, ``Mlincomb``): no
  term bank, no term matrices, nothing prebuilt.  The entry takes the
  problem itself; the refinement and the scan's control, which need terms
  or a scan's shifted solver, do not apply: its control is
  ``rounded_mder``.
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
    kind: str = ""


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
        return Problem(nep, tdt, {"bank": bank}, _shape(inner), mats, fv,
                       "spmf")
    if cfg["kind"] == "dep":
        bank = DiaTermBank.from_matrices(nep.bank.host_csr_terms(), dtype=dt,
                                         device=device)
        dep = nt.DEP(None, tauv=nep.tauv, bank=bank)
        return Problem(dep, tdt, {}, _shape(bank), kind="dep")
    if cfg["kind"] == "protocol":
        return Problem(nep, tdt, {}, None, kind="protocol")
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

    if problem.kind == "protocol":
        raise ValueError(
            "the control rounds the scan's shifted solver, and a protocol "
            "problem has no scan and no terms to round; its control is "
            "rounded_mder")
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


def rounded_mder(problem):
    """For the correctness control of a ``protocol`` problem: the problem
    with every matrix its ``Mder`` and ``Mder_dense`` return rounded through
    the precision below its own (the real and imaginary parts of a
    complex128 matrix through float32), so that the solver sees M(lambda)
    known only to that precision.  Everything else is the problem's own."""
    import copy

    import torch

    if problem.kind != "protocol":
        raise ValueError(
            "the control rounds what Mder returns, and the scans of a "
            f"{problem.kind} problem reach M through its term bank; their "
            "control is bf16_factor")

    # the precision below each in which the parts of a matrix are held
    lower = {torch.float64: torch.float32, torch.float32: torch.bfloat16}

    def rounded(M):
        if not isinstance(M, torch.Tensor) or M.layout != torch.strided:
            M = M.to_dense()
        parts = torch.view_as_real(M) if M.is_complex() else M
        parts = parts.to(lower[parts.dtype]).to(parts.dtype)
        return torch.view_as_complex(parts) if M.is_complex() else parts

    base = type(problem.nep)

    def rounding(name):
        def method(self, lam, der=0):
            return rounded(getattr(base, name)(self, lam, der))
        return method

    cls = type(f"Rounded{base.__name__}", (base,),
               {name: rounding(name) for name in ("Mder", "Mder_dense")
                if hasattr(base, name)})
    nep = copy.copy(problem.nep)
    nep.__class__ = cls
    return nep
