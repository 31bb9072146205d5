"""Halo-exchange row-sharded DIA term banks.

The stacked-DIA bank (``ops/dia.py``) is partitioned into ``ndev``
contiguous row blocks along the ``rows`` axis, operand and vectors alike:
every length-n object a sharded solver touches lives as this rank's
``(blk, ...)`` block.  A banded operator with offsets in
``[-halo_lo, +halo_hi]`` needs the ``halo_hi`` rows after and the ``halo_lo``
rows before its block; those strips come from the two chain neighbours
(``Mesh.neighbour_exchange_start``, zero-filled at the chain ends - exactly
the matrix boundary).

A rank's apply splits the local contraction from the boundary corrections,
as the JAX body does so that the transfer overlaps the bulk
(``neptpu/parallel/halo.py:127-165``), in three steps:

1. start the exchange of the strips;
2. the **bulk**: kernel B1 (``ops/dia_kernel.py``) on the rank's block
   ``(m, ndiag, blk)``, its rows reading the block alone and zeros outside
   it (one ``single`` or ``pair`` launch; on a CPU tensor B1's plain twin);
3. wait for the strips and add the **boundary corrections** of the first
   ``halo_lo`` and last ``halo_hi`` rows, the terms that read a neighbour's
   rows: a few plain torch ops on at most ``halo x ndiag x m`` entries, the
   counterpart of the JAX body's ``jnp`` corrections.

The one-launch window form (the block's bank zero-padded by its halos,
applied to ``[halo_prev; W_d; halo_next]`` after the exchange) stays as
:func:`window_operand` and ``_window_bank``, the reference the split form
is held against.  Not carried over: the jitted-body cache ``_lincomb_fn``
(``halo.py:170``) - the port's scans capture the step as a CUDA graph
instead (``solvers/scan_graph.py``) - and ``device_put`` onto a
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


def _block_bank(data_d, offsets):
    """The bulk's bank: the block's own ``(m, ndiag, blk)`` data as a
    ``blk x blk`` DiaTermBank (B1 reads no row outside it)."""
    blk = data_d.shape[2]
    return DiaTermBank(data_d, offsets, (blk, blk),
                       fro_norms=torch.zeros(data_d.shape[0]))


def _boundary_plan(data_d, offsets, halo_lo, halo_hi):
    """The operands of the boundary corrections of a block ``data_d (m,
    ndiag, blk)``, both strips in one: ``(sides, rows, D, col)`` - the
    strips read, ``"next"`` and/or ``"prev"`` in the order they are joined
    along their columns, the block rows corrected ``(H,)``, their data on
    the offsets reaching out of the block ``(m, nj, H)`` (zero where a
    row's diagonal stays inside it, or past a side's own offsets) and the
    column of the joined strips each reads ``(nj, H)`` - or None where no
    offset leaves the block."""
    blk, dev = data_d.shape[2], data_d.device
    sides, rows, Ds, cols, width = [], [], [], [], 0
    for side, h, sign in (("next", halo_hi, 1), ("prev", halo_lo, -1)):
        js = [j for j, o in enumerate(offsets) if o * sign > 0]
        if not h or not js:
            continue
        t = np.arange(h)[None, :]
        offs = np.asarray([offsets[j] for j in js])[:, None]
        if sign > 0:  # row blk - h + t reads row t - h + off of the next block
            col, r = t - h + offs, np.arange(blk - h, blk)
        else:  # row t reads the strip's column h + t + off (previous block)
            col, r = h + t + offs, np.arange(h)
        keep = torch.as_tensor((col >= 0) & (col < h), device=dev)
        sides.append(side)
        rows.append(r)
        Ds.append(torch.where(keep, data_d[:, js][:, :, r], 0))
        cols.append(np.clip(col, 0, h - 1) + width)
        width += h
    if not sides:
        return None
    nj = max(c.shape[0] for c in cols)
    D = torch.cat([torch.nn.functional.pad(d, (0, 0, 0, nj - d.shape[1]))
                   for d in Ds], dim=2).contiguous()
    col = np.concatenate([np.pad(c, ((0, nj - c.shape[0]), (0, 0)))
                          for c in cols], axis=1)
    return (tuple(sides), torch.as_tensor(np.concatenate(rows), device=dev),
            D, torch.as_tensor(col, device=dev))


def _add_boundary(ys, plan, halo_prev, halo_next):
    """Add the boundary corrections to the bulk rows ``ys`` (one ``(blk,)``
    tensor per channel, in place) from the strips: ``halo_prev``/
    ``halo_next`` ``(channels m, h)``, channel-major, as the exchange
    returns them.  Both strips in one gather, product and sum, then one
    ``index_add_`` a channel."""
    if plan is None:
        return ys
    sides, rows, D, col = plan
    strips = [{"next": halo_next, "prev": halo_prev}[s] for s in sides]
    S = torch.cat(strips, dim=1) if len(strips) > 1 else strips[0]
    dt = ys[0].dtype
    S = S.reshape(len(ys), D.shape[0], -1)[:, :, col].to(dt)
    corr = torch.sum(D.to(dt) * S, dim=(1, 2))  # (channels, H)
    for c, y in enumerate(ys):
        y.index_add_(0, rows, corr[c])
    return ys


class ShardedDiaBank:
    """DiaTermBank split into ``ndev`` contiguous row blocks.

    Built from the whole bank on every rank (the same host input);
    :meth:`device_put` keeps this rank's block on the mesh's device:

    data:   (m, ndiag, blk) - ``data[i, j, r] = A_i[s + r, s + r +
            offsets[j]]`` (s = rank * blk; zero out of range and in the
            padded tail), the bank kernel B1 applies (the bulk);
    the boundary corrections' operands, built from it once.
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
        self.data = self.block = self._plan = None

    def device_put(self, mesh, axis: str = "rows", dtype=None):
        """Keep this rank's block on ``mesh.device`` (in ``dtype``, default
        the bank's), with its bulk bank and boundary operands."""
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
        self.block = _block_bank(block, self.offsets)
        self._plan = _boundary_plan(block, self.offsets, self.halo_lo,
                                    self.halo_hi)
        return self

    def exchange_start(self, WTs, mesh, axis="rows"):
        """Start the exchange of the halo strips of term-major blocks
        ``WTs`` (a sequence of ``(m, blk)``), all in one: a
        :class:`~neptpu_torch.parallel.mesh.PendingExchange` whose
        ``wait()`` gives ``(halo_prev (k m, halo_lo), halo_next (k m,
        halo_hi))``, None for a zero halo."""
        lo, hi, blk = self.halo_lo, self.halo_hi, self.blk
        top = torch.cat([W[:, :hi] for W in WTs]) if hi else None
        bottom = torch.cat([W[:, blk - lo:] for W in WTs]) if lo else None
        return mesh.neighbour_exchange_start(top, bottom, axis)

    def lincomb_t(self, WT, mesh, axis="rows"):
        """This rank's rows of ``y = sum_i A_i W[:, i]`` for its term-major
        block ``WT (m, blk)``: the exchange started, one B1 launch on the
        block, then the boundary corrections from the strips."""
        pending = self.exchange_start((WT,), mesh, axis)
        y = self.block.lincomb_apply_t(WT)
        return _add_boundary((y,), self._plan, *pending.wait())[0]

    def lincomb_pair_t(self, WreT, WimT, mesh, axis="rows"):
        """The re/im channel pair of :meth:`lincomb_t`: the four strips in
        one exchange, the two channels' bulk in one B1 pair launch."""
        pending = self.exchange_start((WreT, WimT), mesh, axis)
        ys = self.block.lincomb_apply_pair_t(WreT, WimT)
        return _add_boundary(ys, self._plan, *pending.wait())


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
    (row-major, as the JAX body takes them).  The bulk is one B1 launch on
    the block (the plain twin on the CPU), then the boundary corrections;
    :class:`ShardedDiaBank` keeps the block's bank and the corrections'
    operands instead of building them a call."""
    dt = torch.promote_types(data_d.dtype, W_d.dtype)
    data_d = data_d.to(dt)
    y = _block_bank(data_d, offsets).lincomb_apply_t(W_d.T.to(dt))
    plan = _boundary_plan(data_d, offsets, halo_lo, halo_hi)
    return _add_boundary((y,), plan,
                         None if halo_prev is None else halo_prev.T,
                         None if halo_next is None else halo_next.T)[0]


def sharded_dia_lincomb(sbank: ShardedDiaBank, W_d, mesh,
                        axis: str = "rows"):
    """``y = sum_i A_i W[:, i]`` with operand and vectors row-sharded.

    ``W_d``: this rank's ``(blk, m)`` block.  Returns this rank's ``(blk,)``
    block of ``y``; the result never leaves the rank."""
    return sbank.lincomb_t(W_d.T.to(sbank.data.dtype).contiguous(), mesh,
                           axis)
