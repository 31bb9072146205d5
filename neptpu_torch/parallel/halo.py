"""Halo-exchange row-sharded DIA term banks.

The stacked-DIA bank (``ops/dia.py``) is partitioned into ``ndev``
contiguous row blocks along the ``rows`` axis, operand and vectors alike:
every length-n object a sharded solver touches lives as this rank's
``(blk, ...)`` block.  A banded operator with offsets in
``[-halo_lo, +halo_hi]`` needs the ``halo_hi`` rows after and the ``halo_lo``
rows before its block; those strips come from the two chain neighbours
(``Mesh.neighbour_exchange``, zero-filled at the chain ends - exactly the
matrix boundary).

The rank's apply is kernel B1 (``ops/dia_kernel.py``) on the rank's
**window**: the block's bank data zero-padded by ``halo_lo`` rows before and
``halo_hi`` rows after, ``(m, ndiag, halo_lo + blk + halo_hi)``, applied to
the term-major operand ``[halo_prev; W_d; halo_next]``.  One ``single`` or
``pair`` launch computes the window's rows, of which rows
``halo_lo : halo_lo + blk`` are the block's (the padded rows carry zero data
and come out zero).  On a CPU tensor the same call runs B1's plain twin.

The JAX body splits the local contraction from the boundary corrections so
that XLA overlaps the transfer with the bulk (``neptpu/parallel/halo.py:
130-165``); here the one launch follows the exchange (the overlap is not
ported).  Not carried over either: the jitted-body cache ``_lincomb_fn``
(``halo.py:170``) - the port launches eagerly - and ``device_put`` onto a
``NamedSharding`` (``halo.py:82``), which here picks this rank's block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dia import DiaTermBank

__all__ = [
    "ShardedDiaBank",
    "halo_exchange",
    "local_halo_lincomb",
    "sharded_dia_lincomb",
    "shard_vector",
    "unshard_vector",
    "window_operand",
]


def _window_bank(data_d, offsets, halo_lo, halo_hi):
    """The window's bank: ``data_d (m, ndiag, blk)`` zero-padded by
    ``halo_lo`` rows before and ``halo_hi`` after, as a DiaTermBank (its
    launcher is built once per dtype at the first apply)."""
    data = torch.nn.functional.pad(data_d, (halo_lo, halo_hi)).contiguous()
    n_ext = data.shape[2]
    return DiaTermBank(data, offsets, (n_ext, n_ext),
                       fro_norms=torch.zeros(data.shape[0]))


def window_operand(WT, halo_prev, halo_next):
    """The term-major window operand ``[halo_prev; W_d; halo_next]`` along
    the rows: ``WT (m, blk)``, the strips ``(m, halo_lo)``/``(m, halo_hi)``
    or None."""
    parts = [p for p in (halo_prev, WT, halo_next) if p is not None]
    return torch.cat(parts, dim=1).contiguous()


class ShardedDiaBank:
    """DiaTermBank split into ``ndev`` contiguous row blocks.

    Built from the whole bank on every rank (the same host input);
    :meth:`device_put` keeps this rank's block on the mesh's device:

    data:    (m, ndiag, blk) — ``data[i, j, r] = A_i[s + r, s + r +
             offsets[j]]`` (s = rank * blk; zero out of range and in the
             padded tail);
    window:  the block's window bank ``(m, ndiag, halo_lo + blk + halo_hi)``
             that kernel B1 applies.
    """

    def __init__(self, bank: DiaTermBank, ndev: int):
        if not hasattr(bank, "offsets"):
            raise TypeError(
                "ShardedDiaBank requires a DiaTermBank (banded operands); "
                f"got {type(bank).__name__}. Build the NEP with fmt='dia' "
                "or use RowShardedBank for general sparsity.")
        n, m, offs = bank.n, bank.nterms, bank.offsets
        blk = -(-n // ndev)
        max_off = max((abs(o) for o in offs), default=0)
        if max_off > blk:
            raise ValueError(f"bandwidth {max_off} exceeds row block {blk}; "
                             "use fewer devices or a wider block")
        self.bank = bank
        self.offsets = tuple(int(o) for o in offs)
        self.n, self.ndev, self.blk, self.nterms = n, ndev, blk, m
        self.halo_hi = max((o for o in self.offsets if o > 0), default=0)
        self.halo_lo = max((-o for o in self.offsets if o < 0), default=0)
        self.data = self.window = None

    def device_put(self, mesh, axis: str = "rows", dtype=None):
        """Keep this rank's block on ``mesh.device`` (in ``dtype``, default
        the bank's) and build its window bank."""
        if mesh.size(axis) != self.ndev:
            raise ValueError(f"bank split {self.ndev} ways, mesh axis {axis!r}"
                             f" has {mesh.size(axis)} ranks")
        r = mesh.rank(axis)
        lo, hi = r * self.blk, min((r + 1) * self.blk, self.n)
        src = self.bank.data
        block = torch.zeros((self.nterms, len(self.offsets), self.blk),
                            dtype=dtype or src.dtype, device=mesh.device)
        if hi > lo:
            block[:, :, : hi - lo] = src[:, :, lo:hi].to(block.device,
                                                         block.dtype)
        self.data = block
        self.window = _window_bank(block, self.offsets, self.halo_lo,
                                   self.halo_hi)
        return self

    def exchange_t(self, WTs, mesh, axis="rows"):
        """Halo strips of term-major blocks ``WTs`` (a sequence of
        ``(m, blk)``), all in one exchange: ``(halo_prev (k m, halo_lo),
        halo_next (k m, halo_hi))``, None for a zero halo."""
        lo, hi, blk = self.halo_lo, self.halo_hi, self.blk
        top = torch.cat([W[:, :hi] for W in WTs]) if hi else None
        bottom = torch.cat([W[:, blk - lo:] for W in WTs]) if lo else None
        return mesh.neighbour_exchange(top, bottom, axis)

    def _rows(self, y):
        return y[self.halo_lo: self.halo_lo + self.blk]

    def lincomb_t(self, WT, mesh, axis="rows"):
        """This rank's rows of ``y = sum_i A_i W[:, i]`` for its term-major
        block ``WT (m, blk)``: one exchange, one B1 launch on the window."""
        prev, nxt = self.exchange_t((WT,), mesh, axis)
        y = self.window.lincomb_apply_t(window_operand(WT, prev, nxt))
        return self._rows(y)

    def lincomb_pair_t(self, WreT, WimT, mesh, axis="rows"):
        """The re/im channel pair of :meth:`lincomb_t`: the four strips go in
        one exchange, the two channels in one B1 pair launch."""
        m = WreT.shape[0]
        prev, nxt = self.exchange_t((WreT, WimT), mesh, axis)
        ops = [window_operand(W, None if prev is None else prev[s],
                              None if nxt is None else nxt[s])
               for W, s in ((WreT, slice(0, m)), (WimT, slice(m, 2 * m)))]
        yre, yim = self.window.lincomb_apply_pair_t(*ops)
        return self._rows(yre), self._rows(yim)


def shard_vector(x, mesh, blk, axis: str = "rows"):
    """This rank's zero-padded block ``(blk[, k])`` of a host ``(n[, k])``
    array, on ``mesh.device``."""
    x = torch.as_tensor(np.asarray(x))
    r = mesh.rank(axis)
    out = torch.zeros((blk,) + tuple(x.shape[1:]), dtype=x.dtype)
    part = x[r * blk: (r + 1) * blk]
    out[: part.shape[0]] = part
    return out.to(mesh.device)


def unshard_vector(x_d, n, mesh, axis: str = "rows"):
    """The full ``(n[, k])`` vector from every rank's ``(blk[, k])`` block
    (an ``all_gather``)."""
    xs = mesh.all_gather(x_d, axis)
    return xs.reshape((-1,) + tuple(xs.shape[2:]))[:n]


def halo_exchange(W_d, halo_lo: int, halo_hi: int, mesh, axis: str = "rows"):
    """Exchange boundary strips with the two chain neighbours.

    ``W_d``: this rank's ``(blk, ...)`` block.  Returns ``(halo_prev,
    halo_next)``: the last ``halo_lo`` rows of the previous block and the
    first ``halo_hi`` rows of the next block (zeros at the chain ends, None
    for a zero halo)."""
    top = W_d[:halo_hi].contiguous() if halo_hi else None
    bottom = W_d[W_d.shape[0] - halo_lo:].contiguous() if halo_lo else None
    return mesh.neighbour_exchange(top, bottom, axis)


def local_halo_lincomb(data_d, offsets, W_d, halo_prev, halo_next,
                       halo_lo: int, halo_hi: int):
    """One rank's rows of ``y = sum_i A_i W[:, i]``: ``data_d (m, ndiag,
    blk)``, ``W_d (blk, m)`` and the strips ``(halo_lo, m)``/``(halo_hi, m)``
    (row-major, as the JAX body takes them).  The window bank and operand
    are built for this call and B1 runs once on them (the plain twin on the
    CPU); :class:`ShardedDiaBank` keeps its window bank instead."""
    dt = torch.promote_types(data_d.dtype, W_d.dtype)
    win = _window_bank(data_d.to(dt), offsets, halo_lo, halo_hi)
    WT = window_operand(W_d.T.to(dt),
                        None if halo_prev is None else halo_prev.T.to(dt),
                        None if halo_next is None else halo_next.T.to(dt))
    y = win.lincomb_apply_t(WT)
    return y[halo_lo: halo_lo + W_d.shape[0]]


def sharded_dia_lincomb(sbank: ShardedDiaBank, W_d, mesh,
                        axis: str = "rows"):
    """``y = sum_i A_i W[:, i]`` with operand and vectors row-sharded.

    ``W_d``: this rank's ``(blk, m)`` block.  Returns this rank's ``(blk,)``
    block of ``y``; the result never leaves the rank."""
    return sbank.lincomb_t(W_d.T.to(sbank.data.dtype).contiguous(), mesh,
                           axis)
