"""Carry state computed by the JAX package across to the port (no JAX here).

A JAX bank or solver is a pytree: ``obj.tree_flatten()`` gives its leaves
(arrays, or nested pytree objects) and its static aux data.  Turned into
numpy, that is a *spec* triple ``(kind, leaves, aux)``: ``kind`` the class
name, ``leaves`` a list whose entries are numpy arrays, ``None``, tuples of
those, or nested spec triples.  The functions below rebuild the port's
objects from such specs so that both packages compute from identical
operands and identical state.  ``device=None`` is the card, as everywhere in
the port.  (Pivots: the JAX package stores 0-based LU
pivots, ``torch.linalg`` 1-based ones.)
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .models.dep import DEP
from .ops.dia import DiaTermBank
from .ops.mixed import MixedTermBank
from .ops.partitioned import (BatchedShiftSMW, BlockTridiagSolver,
                              InterleavedSMW, PartitionedBandedSolver)
from .ops.sparse import DenseTermBank, SparseTermBank
from .solvers.iar_real import DenseBlockLU

__all__ = ["bank_from_arrays", "dep_from_arrays", "block_lu_from_arrays",
           "shift_solver_from_arrays", "batched_shift_solver_from_arrays",
           "carry_from_arrays", "deflated_from_arrays", "proj_from_arrays",
           "wep_fd_from_arrays"]


def _t(x, device, dtype=None):
    if x is None:
        return None
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _pivots(piv, device):
    """0-based pivots -> torch's 1-based int32 pivots."""
    return torch.as_tensor(np.asarray(piv).astype(np.int32) + 1,
                           device=device)


def bank_from_arrays(spec, device=None):
    """A term bank from the spec of a JAX ``DiaTermBank``,
    ``SparseTermBank``, ``DenseTermBank`` or ``MixedTermBank``."""
    device = resolve_device(device)
    kind, leaves, aux = spec
    if kind == "DiaTermBank":
        data, fro = leaves
        offsets, shape = aux
        return DiaTermBank(_t(data, device), offsets, shape,
                           fro_norms=_t(fro, device))
    if kind == "SparseTermBank":
        data, indices, row_ids, indptr, fro = leaves
        return SparseTermBank(_t(data, device),
                              _t(indices, device, torch.int64),
                              _t(row_ids, device, torch.int64),
                              _t(indptr, device, torch.int64), aux[0],
                              fro_norms=_t(fro, device))
    if kind == "DenseTermBank":
        A, fro = leaves
        return DenseTermBank(_t(A, device), fro_norms=_t(fro, device))
    if kind == "MixedTermBank":
        inner, Lr, Ur, Li, Ui, fro = leaves
        main_idx, tidx_r, tidx_i, shape, nterms = aux
        return MixedTermBank(bank_from_arrays(inner, device), _t(Lr, device),
                             _t(Ur, device), _t(Li, device), _t(Ui, device),
                             main_idx, tidx_r, tidx_i, shape, nterms,
                             fro_norms=_t(fro, "cpu"))
    raise ValueError(f"unknown bank kind {kind!r}")


def dep_from_arrays(bank_spec, tauv, device=None):
    """A :class:`DEP` over the bank of a JAX ``DEP`` (``bank_spec``: the spec
    of its ``bank`` — for a banded problem the ``DiaTermBank``'s ``data``,
    ``fro_norms``, ``offsets`` and ``shape``) and its delays ``tauv``."""
    return DEP(None, tauv=np.asarray(tauv),
               bank=bank_from_arrays(bank_spec, device))


def block_lu_from_arrays(lu, piv, device=None):
    """A :class:`DenseBlockLU` from the ``(lu, piv)`` pair of the JAX
    package's ``dep_shift_block_lu``/``spmf_shift_block_lu`` (0-based
    pivots)."""
    device = resolve_device(device)
    return DenseBlockLU(_t(lu, device), _pivots(piv, device))


def shift_solver_from_arrays(spec, device=None):
    """A shifted solver from the spec of a JAX ``InterleavedSMW``,
    ``PartitionedBandedSolver``, ``BlockTridiagSolver`` or ``DenseBlockLU``."""
    device = resolve_device(device)
    kind, leaves, aux = spec
    if kind == "InterleavedSMW":
        base, X, Uh, Lh, K_fac, K_piv = leaves
        mode, refine = aux
        base = shift_solver_from_arrays(base, device)
        if K_piv is not None:
            K_piv = (_pivots(K_piv, device) if mode == "lu"
                     else _t(K_piv, device, torch.int32))
        return InterleavedSMW.from_factors(
            base, _t(X, device), _t(Uh, device), _t(Lh, device),
            _t(K_fac, device), K_piv, mode, refine)
    if kind == "PartitionedBandedSolver":
        fac, piv, V, W, r_fac, r_piv, strips, DBC = leaves
        offsets, p, blk, b, n, mode = aux
        if mode == "lu":
            piv, r_piv = _pivots(piv, device), _pivots(r_piv, device)
        else:
            piv = _t(piv, device, torch.int32)
            r_piv = _t(r_piv, device, torch.int32)
        return PartitionedBandedSolver.from_factors(
            _t(fac, device), piv, _t(V, device), _t(W, device),
            _t(r_fac, device), r_piv, _t(strips, device),
            tuple(_t(x, device) for x in DBC), offsets, p, blk, b, n, mode)
    if kind == "BlockTridiagSolver":
        Sinv, B, C, D, strips = leaves
        offsets, nblk, bt, n, mode, refine = aux
        return BlockTridiagSolver.from_factors(
            _t(Sinv, device), _t(B, device), _t(C, device), _t(D, device),
            _t(strips, device), offsets, nblk, bt, n, mode, refine)
    if kind == "DenseBlockLU":
        lu, piv = leaves
        return DenseBlockLU(_t(lu, device), _pivots(piv, device))
    raise ValueError(f"unknown solver kind {kind!r}")


def batched_shift_solver_from_arrays(state, device=None):
    """A :class:`BatchedShiftSMW` from the attributes of the JAX package's
    (``vars(obj)`` with every array as numpy): the factors of all shifts with
    their leading shift axis, so both packages solve from identical state.
    Reads the mixed-precision layout when ``state["ir"]`` is set, else the
    plain one."""
    device = resolve_device(device)
    offsets, p, blk, b, n2, mode = state["aux"]
    obj = BatchedShiftSMW.__new__(BatchedShiftSMW)
    obj.aux = (tuple(int(o) for o in offsets), p, blk, b, n2, mode)
    obj.ir, obj.refine = int(state["ir"]), int(state["refine"])
    obj.n, obj.S_real = int(state["n"]), int(state["S_real"])
    obj.device = device
    if mode == "lu":
        piv = _pivots(state["piv"], device)
        r_piv = _pivots(state["r_piv"], device)
    else:
        piv = _t(state["piv"], device, torch.int32)
        r_piv = _t(state["r_piv"], device, torch.int32)
    DBC = (tuple(_t(x, device) for x in state["DBC"]) if not obj.ir
           else (None, None, None))
    base = PartitionedBandedSolver.from_factors(
        _t(state["fac"], device), piv, _t(state["V"], device),
        _t(state["W"], device), _t(state["r_fac"], device), r_piv,
        _t(state["strips_b"], device), DBC, *obj.aux)
    if obj.ir:
        obj.base = base
        obj.btdims = tuple(int(x) for x in state["btdims"])
        for name, key in (("D64", "D64"), ("B64", "B64"), ("C64", "C64"),
                          ("X64", "X64"), ("Kinv64", "Kinv64"),
                          ("Lh64", "Ltil64"), ("Uh64", "Util64")):
            setattr(obj, name, _t(state[key], device, torch.float64))
        return obj
    K_piv = (_pivots(state["K_piv"], device) if mode == "lu"
             else _t(state["K_piv"], device, torch.int32))
    obj.smw = InterleavedSMW.from_factors(
        base, _t(state["X"], device), _t(state["Util_b"], device),
        _t(state["Ltil_b"], device), _t(state["K_fac"], device), K_piv, mode,
        obj.refine)
    return obj


def carry_from_arrays(*arrays, device=None):
    """A scan carry from numpy arrays — the IAR carry ``(Vre, Vim, Hre,
    Him)`` or the TIAR carry ``(Zre, Zim, are, aim, Hre, Him)`` — as fresh
    tensors (the port's scans update their carry in place)."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(x), device=device) for x in arrays)


def deflated_from_arrays(orgnep, S0, V0, mode=":SPMF"):
    """The deflated NEP over the port's ``orgnep`` (built from the JAX
    original's operands, e.g. by :func:`dep_from_arrays`) for the invariant
    pair ``(S0, V0)`` of a JAX deflated NEP, taken as it is (no new
    normalization), in ``mode`` (``":SPMF"``, ``":Generic"`` or ``":MM"``)."""
    from .models.deflation import _make

    return _make(orgnep, np.asarray(S0), np.asarray(V0), mode)


def proj_from_arrays(orgnep, W, V, maxsize=None):
    """The projected NEP ``W^H M(lam) V`` of the port's ``orgnep`` for the
    bases ``(W, V)`` of a JAX projected NEP (numpy), on ``orgnep``'s
    device."""
    from .models.projection import create_proj_NEP

    pnep = create_proj_NEP(orgnep, maxsize)
    pnep.set_projectmatrices(torch.as_tensor(np.asarray(W)),
                             torch.as_tensor(np.asarray(V)))
    return pnep


def wep_fd_from_arrays(spec, device=None):
    """A native waveguide :class:`WEP_FD` from the parts of a JAX one:
    ``spec`` a mapping with ``nx``, ``nz``, ``hx``, ``hz``, ``Dxx``,
    ``Dzz``, ``Dz`` (dense or scipy), ``C1``, ``C2T`` (scipy or dense),
    ``K`` (nz x nx, already shifted by its mean, as the JAX problem stores
    it), ``k_bar`` and the exterior wavenumbers ``Km``, ``Kp``."""
    from .models.gallery.waveguide import WEP_FD

    return WEP_FD.from_parts(
        spec["nx"], spec["nz"], spec["hx"], spec["hz"], spec["Dxx"],
        spec["Dzz"], spec["Dz"], spec["C1"], spec["C2T"], spec["K"],
        spec["k_bar"], spec["Km"], spec["Kp"], device=resolve_device(device))
