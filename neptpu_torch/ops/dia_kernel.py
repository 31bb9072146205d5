"""The stacked-DIA fused multi-term SpMV: hand-written CUDA kernel + plain twin.

    y[r] = sum_d sum_i data[i, d, r] * WT[i, r + offsets[d]]

(WT read as zero outside ``[0, n)``).  The operand is **term-major**,
``WT (m, n)`` contiguous: the layout the TPU kernel
(``neptpu/ops/pallas_spmv.py``, ``pad_dia_operand``) takes, the one the
complex-as-real scans hold their term weights in, and on the card the
coalesced one.  ``dia_lincomb`` launches the sm_90a kernel in
``neptpu_torch/csrc/dia_spmv.cu``; ``dia_lincomb_pair`` applies one bank to a
re/im operand pair in a single launch that reads the bank once.  Both take
float32 or float64 (result in the data type) and bfloat16 (bank and operands
bfloat16, every product and the whole sum in float32, float32 result - the
TPU kernel's second dtype).  ``dia_lincomb_plain`` and
``dia_lincomb_pair_plain`` are their plain PyTorch twins, the CPU path and the
kernels' test oracle.

:class:`DiaLauncher` is a bank prepared for launching: the bank is validated
once, its constants (data pointer, sizes, the offsets, which ride in the
kernel's parameter block) sit ready in one C struct, and a call checks only
its operands, allocates the result and makes one ctypes call on the current
stream.  ``dia_lincomb`` and ``dia_lincomb_pair`` prepare a launcher per call.

The kernel is compiled by ``nvcc`` on first use into ``neptpu_torch/_build/``
(file name keyed by the source's content hash) and bound through ``ctypes``
with a plain C interface.  Nothing here imports or builds anything at module
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..core import trace

__all__ = [
    "DIA_SPMV",
    "DiaLauncher",
    "result_dtype",
    "dia_lincomb",
    "dia_lincomb_pair",
    "dia_lincomb_plain",
    "dia_lincomb_pair_plain",
    "empty_launch",
    "shifted_rows",
    "build_kernel",
    "is_generic",
    "generic_plan",
    "GenericPlan",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dia_spmv.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _find_nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the DIA SpMV kernel is built from "
                           "source and needs the CUDA toolkit")
    return found


# data dtype -> suffix of the C entry points
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}


def result_dtype(dtype):
    """The accumulator and result dtype of a bank dtype: float32 for
    bfloat16, else the dtype itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


class KernelLibrary:
    """One CUDA source built into a shared library on first use.

    ``counts`` holds, per wrapper, the kernel launches made through it (and
    only there); ``launches`` is their sum.  ``entry_counts`` splits the same
    launches by C entry point (``dia_lincomb_pair_f32``, ...), one per data
    type; ``generic_counts`` counts, by entry point, those of them that went
    to the generic body (:func:`is_generic` banks).  ``build_seconds`` and
    ``build_log`` record the last build."""

    def __init__(self, name, source):
        self.name = name
        self.source = source
        self.counts = {"dia_lincomb": 0, "dia_lincomb_pair": 0}
        self.entry_counts = {f"{entry}_{sfx}": 0 for entry in self.counts
                             for sfx in _SUFFIX.values()}
        self.generic_counts = dict(self.entry_counts)
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def launches(self):
        return sum(self.counts.values())

    def _all_counts(self):
        return self.counts, self.entry_counts, self.generic_counts

    def reset_counts(self):
        for counts in self._all_counts():
            for key in counts:
                counts[key] = 0

    def snapshot(self):
        """A copy of the counts: ``(counts, entry_counts,
        generic_counts)``."""
        return tuple(dict(counts) for counts in self._all_counts())

    def launches_since(self, snapshot):
        """The launches counted since ``snapshot``, in its form."""
        return tuple({key: now[key] - then[key] for key in now}
                     for now, then in zip(self._all_counts(), snapshot))

    def add_counts(self, delta, times=1):
        """Add ``times`` times the launches ``delta`` (as
        :meth:`launches_since` gives them) to the counts.  A CUDA graph's
        capture counts the launches it records though it runs none
        (``times=-1`` takes them off again); a replay runs them without a
        call that counts (``times=1`` a replay)."""
        for counts, d in zip(self._all_counts(), delta):
            for key, v in d.items():
                counts[key] += times * v

    def library_path(self):
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{digest.hexdigest()[:16]}.so")

    def build(self):
        """The path of the shared library, built first where it is not
        there yet."""
        path = self.library_path()
        if not os.path.exists(path):
            self._build(path)
        return path

    def load(self):
        with self._lock:
            if self._lib is None:
                with trace.load_span("nt.load.kernel_library"):
                    self._lib = self._open()
            return self._lib

    def _open(self):
        """Build where needed, open and declare the library."""
        lib = ctypes.CDLL(self.build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        bank = ctypes.POINTER(BankStruct)
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"dia_lincomb_{sfx}")
            fn.argtypes = [bank, ptr, ptr, ptr]
            fn.restype = i32
            fn = getattr(lib, f"dia_lincomb_pair_{sfx}")
            fn.argtypes = [bank, ptr, ptr, ptr, ptr, ptr]
            fn.restype = i32
        lib.dia_noop.argtypes = [ptr]
        lib.dia_noop.restype = i32
        lib.dia_error_string.argtypes = [i32]
        lib.dia_error_string.restype = ctypes.c_char_p
        return lib

    def check(self, rc, what):
        """Raise on a non-zero ``cudaGetLastError()`` of a launch."""
        if rc != 0:
            raise RuntimeError(
                f"{what} kernel launch failed: "
                f"{self.load().dia_error_string(rc).decode()} ({rc})")

    def _build(self, path):
        import time

        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{self.source}:\n{self.build_log}")
        # atomic: a concurrent build never leaves a half-written library
        os.replace(tmp, path)


DIA_SPMV = KernelLibrary("dia_spmv", SOURCE)


def build_kernel():
    """Build (or load the cached build of) the DIA SpMV kernel library."""
    return DIA_SPMV.load()


# offsets up to this many ride in the kernel's parameter block (the C
# struct's capacity); a wider bank passes them as a device array
MAX_BY_VALUE = 256
# the rows per thread the library is built for: packed loads (8 bfloat16 =
# 16 bytes of bank a load) where n is a multiple of the width; float32 and
# float64 gained nothing from packed rows on the H100 and have none.  The C
# side falls back to one row per thread on an operand that is not 16-byte
# aligned.
ROWS_BUILT = {torch.float32: (1,), torch.float64: (1,),
              torch.bfloat16: (1, 8)}
# below this many rows one row per thread, so the grid covers the card's SMs
# (packed rows were slower at n = 1e4: 5.6-6.6 us against 2.3 us)
WIDE_MIN_ROWS = 1 << 17


# the generic body (banks wider than the narrow body's 16 offsets or 4
# terms), as the CUDA source has them (kGroups, kRowThreads, kGenericSmem,
# kMaxClusters): fixed runs of the (diagonal, term) streams, each summed
# from zero and added in order (a warp each in the split kernel), threads of
# a block of the rows kernel, shared memory a block may hold (windows, then
# the warps' partial sums), staged windows at most
GENERIC_RUNS = 8
ROW_THREADS = 128
GENERIC_SMEM = 48 * 1024
MAX_CLUSTERS = 32
# below this many rows the generic body splits each 64-row tile's streams
# among the 8 warps of its block (an n ~ 1e4 bank keeps ~180 blocks); from
# here each of a block's 128 threads walks all streams for its own 4 row
# groups (2 of double or of bfloat16 pairs): 528 blocks of 512 float rows
# and more, four for each of the H100's 132 SMs
GENERIC_WIDE_ROWS = 4 * 132 * ROW_THREADS * 4
# the narrow body's reach (kNarrow, kMaxTerms of the CUDA source)
NARROW_OFFSETS, NARROW_TERMS = 16, 4


def is_generic(m, ndiag):
    """Whether an ``(m, ndiag, n)`` bank runs the generic body (more than
    16 offsets or more than 4 terms) rather than the narrow one."""
    return ndiag > NARROW_OFFSETS or m > NARROW_TERMS


class GenericPlan:
    """Where the generic body finds the operand of a bank, made once a bank
    on the host by :func:`generic_plan`.

    ``split``: the split kernel (a tile of ``32 * rows * gvec`` rows, each
    warp one run of the streams), else the rows kernel (a tile of
    ``128 * rows * gvec`` rows, each thread all streams for its own
    ``rows`` groups of ``gvec``).  ``clusters`` lists the
    staged windows as ``(start, len, base)``: for the tile starting at row
    ``r0`` the operand elements ``[r0 + start, r0 + start + len)`` of every
    term, held at ``[base, base + len)`` of that term's window of ``window``
    elements.  ``pos[d]``: row ``r0 + t`` of diagonal d's operand
    (``W[i, r0 + t + offsets[d]]``) sits at ``pos[d] + t`` of the window, or
    -1 where that diagonal's cluster is not staged and the kernel reads the
    operand through L1."""

    def __init__(self, split, rows, gvec, window, clusters, pos):
        self.split, self.rows, self.gvec = split, rows, gvec
        self.window = window
        self.tile = (32 if split else ROW_THREADS) * rows * gvec
        self.clusters = tuple(clusters)
        self.pos = tuple(pos)

    def __repr__(self):
        staged = sum(p >= 0 for p in self.pos)
        return (f"GenericPlan({'split' if self.split else 'rows'}, "
                f"tile={self.tile}, rows={self.rows}, "
                f"gvec={self.gvec}, window={self.window}, "
                f"{len(self.clusters)} staged windows, {staged} of "
                f"{len(self.pos)} diagonals staged)")


def generic_plan(offsets, n, m, itemsize, gvec=1, stage=True):
    """The generic body's :class:`GenericPlan` for a bank of ``m`` terms with
    ``offsets`` at ``n`` rows, ``itemsize`` bytes an element, ``gvec``
    consecutive rows a lane loads as one word.

    The sorted distinct offsets form clusters: an offset joins the cluster
    before it where the gap is at most a tile (a separate window would cost
    a tile of elements more) and the cluster's window still fits.  Clusters
    are staged, the most diagonals per window element first, while the
    windows of all terms of a PAIR launch fit ``GENERIC_SMEM`` (so one plan
    serves both entries); a cluster's window is ``tile + span + 2`` elements
    rounded up to even, starting at an even row offset, so bfloat16 windows
    can move as aligned 4-byte pairs.  The rows kernel (``n`` from
    ``GENERIC_WIDE_ROWS``) stages nothing, and neither does ``stage=False``:
    every diagonal then reads the operand through L1."""
    split = n < GENERIC_WIDE_ROWS
    rows = 2 if split or itemsize == 8 or gvec == 2 else 4
    tile = (32 if split else ROW_THREADS) * rows * gvec
    budget = GENERIC_SMEM // (2 * m * itemsize)  # a term's window elements
    if not (stage and split):
        budget = 0
    max_span = budget - tile - 3
    groups = []  # [lo, hi, diagonals]
    count = {}
    for o in offsets:
        count[o] = count.get(o, 0) + 1
    for o in sorted(count):
        if (groups and o - groups[-1][1] <= tile
                and o - groups[-1][0] <= max_span):
            groups[-1][1] = o
            groups[-1][2] += count[o]
        else:
            groups.append([o, o, count[o]])

    def length(g):
        span = g[1] - g[0]
        return (tile + span + 3) // 2 * 2

    staged, total = [], 0
    for g in sorted(groups, key=lambda g: (-g[2] / length(g), g[0])):
        if len(staged) < MAX_CLUSTERS and total + length(g) <= budget:
            staged.append(g)
            total += length(g)
    staged.sort()
    clusters, where, base = [], {}, 0
    for lo, hi, _ in staged:
        start = lo - (lo & 1)  # even, at or below lo
        clusters.append((start, length((lo, hi)), base))
        for o in count:
            if lo <= o <= hi:
                where[o] = base + o - start
        base += length((lo, hi))
    return GenericPlan(split, rows, gvec, base, clusters,
                       [where.get(o, -1) for o in offsets])


class ClustersStruct(ctypes.Structure):
    """``Clusters`` of ``csrc/dia_spmv.cu``: the staged windows."""

    _fields_ = [("count", ctypes.c_int),
                ("window", ctypes.c_int),
                ("start", ctypes.c_int * MAX_CLUSTERS),
                ("len", ctypes.c_int * MAX_CLUSTERS),
                ("base", ctypes.c_int * MAX_CLUSTERS)]


class BankStruct(ctypes.Structure):
    """``DiaBank`` of ``csrc/dia_spmv.cu``: what a launch needs of a bank."""

    _fields_ = [("data", ctypes.c_void_p),
                ("offsets_dev", ctypes.c_void_p),
                ("n", ctypes.c_longlong),
                ("m", ctypes.c_int),
                ("ndiag", ctypes.c_int),
                ("vec", ctypes.c_int),
                ("offsets", ctypes.c_int * MAX_BY_VALUE),
                ("pos_dev", ctypes.c_void_p),
                ("split", ctypes.c_int),
                ("rows", ctypes.c_int),
                ("gvec", ctypes.c_int),
                ("clusters", ClustersStruct),
                ("pos", ctypes.c_int * MAX_BY_VALUE)]


def rows_per_thread(dtype, n):
    """Rows a thread owns in an ``n``-row bank: the dtype's packed width
    where there are rows enough to fill the card with packed loads and ``n``
    keeps every bank row aligned, else 1."""
    wide = ROWS_BUILT[dtype][-1]
    return wide if n >= WIDE_MIN_ROWS and n % wide == 0 else 1


def _raw_stream(index):
    """The current stream of device ``index`` as the integer the C side
    takes, without building a ``Stream`` object where this PyTorch can."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


class DiaLauncher:
    """One bank (``data (m, ndiag, n)`` contiguous, float32, float64 or
    bfloat16; ``offsets`` a sequence of ``ndiag`` ints) prepared for
    launching the kernels of ``DIA_SPMV``.

    Construction validates the bank and fills the C struct; it neither
    builds nor loads the library (the first launch does).  ``single`` and
    ``pair`` check their operands - dtype of the bank, shape ``(m, n)``,
    contiguous, on the bank's CUDA device - and raise on anything else:
    there is no fallback to the plain twin.  They launch on the current
    stream, do not synchronise and read nothing back, so they can be
    captured into a CUDA graph."""

    def __init__(self, data, offsets):
        offsets = tuple(int(o) for o in offsets)
        if data.dtype not in _SUFFIX:
            raise TypeError("the DIA kernels take float32, float64 or "
                            f"bfloat16 data, got {data.dtype}")
        if data.ndim != 3:
            raise ValueError("the DIA kernels take data (m, ndiag, n), got "
                             f"shape {tuple(data.shape)}")
        if not data.is_contiguous():
            raise ValueError("the DIA kernels need contiguous data")
        m, ndiag, n = data.shape
        if len(offsets) != ndiag:
            raise ValueError(f"{len(offsets)} offsets for {ndiag} diagonals")
        if any(abs(o) >= 2**31 for o in offsets):
            raise ValueError("offsets must fit in 32 bits")
        self.data = data  # kept alive: the struct holds its pointer
        self.offsets = offsets
        self.dtype, self.device = data.dtype, data.device
        self.result_dtype = result_dtype(data.dtype)
        self.m, self.ndiag, self.n = m, ndiag, n
        self._shape = (m, n)
        self._on_cuda = data.device.type == "cuda"
        self._index = data.device.index
        self._row_bytes = n * (4 if data.dtype == torch.bfloat16
                               else data.element_size())
        self._offsets_dev = self._pos_dev = None
        bank = BankStruct()
        # the generic body's plan; bfloat16 rows go in aligned pairs where
        # every bank row starts 4-byte aligned
        self.generic = is_generic(m, ndiag)
        self.plan = None
        if self.generic:
            pairs = (data.dtype == torch.bfloat16 and n % 2 == 0
                     and data.data_ptr() % 4 == 0)
            self.plan = plan = generic_plan(offsets, n, m,
                                            data.element_size(),
                                            2 if pairs else 1)
            bank.split, bank.rows, bank.gvec = plan.split, plan.rows, plan.gvec
            cl = bank.clusters
            cl.count, cl.window = len(plan.clusters), plan.window
            for c, (start, length, base) in enumerate(plan.clusters):
                cl.start[c], cl.len[c], cl.base[c] = start, length, base
            for d, p in enumerate(plan.pos[:MAX_BY_VALUE]):
                bank.pos[d] = p
        if self._on_cuda:
            bank.data = data.data_ptr()
            if ndiag > MAX_BY_VALUE:
                self._offsets_dev = torch.tensor(offsets, dtype=torch.int32,
                                                 device=data.device)
                bank.offsets_dev = self._offsets_dev.data_ptr()
                self._pos_dev = torch.tensor(self.plan.pos,
                                             dtype=torch.int32,
                                             device=data.device)
                bank.pos_dev = self._pos_dev.data_ptr()
        bank.n, bank.m, bank.ndiag = n, m, ndiag
        for d, o in enumerate(offsets[:MAX_BY_VALUE]):
            bank.offsets[d] = o
        self._bank = bank
        self._ref = ctypes.byref(bank)
        self.vec = bank.vec = rows_per_thread(data.dtype, n)
        sfx = _SUFFIX[data.dtype]
        self._entries = {"dia_lincomb": f"dia_lincomb_{sfx}",
                         "dia_lincomb_pair": f"dia_lincomb_pair_{sfx}"}
        self._fns = {}

    def _check(self, W, name):
        if W.dtype != self.dtype:
            raise TypeError("the DIA kernels take data and operands of one "
                            f"dtype, got {self.dtype} and {W.dtype} ({name})")
        if W.shape != self._shape:
            raise ValueError(f"{name} has shape {tuple(W.shape)}, data "
                             f"{tuple(self.data.shape)} needs the term-major "
                             f"{self._shape}")
        if not W.is_contiguous():
            raise ValueError(f"the DIA kernels need contiguous {name}")
        if not self._on_cuda or W.device != self.device:
            if W.device.type != "cuda" or not self._on_cuda:
                raise ValueError("the DIA kernels need CUDA tensors; data is "
                                 f"on {self.device}, {name} on {W.device}")
            raise ValueError("data and operands on different devices")

    def _launch(self, entry, *pointers):
        fn = self._fns.get(entry)
        if fn is None:
            fn = self._fns[entry] = getattr(DIA_SPMV.load(),
                                            self._entries[entry])
        if self._index == torch.cuda.current_device():
            rc = fn(self._ref, *pointers, _raw_stream(self._index))
        else:
            with torch.cuda.device(self._index):
                rc = fn(self._ref, *pointers, _raw_stream(self._index))
        if rc:
            DIA_SPMV.check(rc, entry)
        DIA_SPMV.counts[entry] += 1
        DIA_SPMV.entry_counts[self._entries[entry]] += 1
        if self.generic:
            DIA_SPMV.generic_counts[self._entries[entry]] += 1

    def single(self, WT):
        """``y (n,)`` for one term-major operand ``WT (m, n)``."""
        self._check(WT, "WT")
        y = torch.empty(self.n, dtype=self.result_dtype, device=self.device)
        self._launch("dia_lincomb", WT.data_ptr(), y.data_ptr())
        return y

    def pair(self, WreT, WimT):
        """``(yre, yim)`` for an operand pair in one launch, the bank read
        once; equal to two ``single`` launches bit for bit."""
        self._check(WreT, "WreT")
        self._check(WimT, "WimT")
        y = torch.empty((2, self.n), dtype=self.result_dtype,
                        device=self.device)
        p = y.data_ptr()
        self._launch("dia_lincomb_pair", WreT.data_ptr(), WimT.data_ptr(), p,
                     p + self._row_bytes)
        return y.unbind(0)


def dia_lincomb(data, offsets, WT):
    """Launch the CUDA kernel: ``data (m, ndiag, n)``, ``offsets`` a sequence
    of ``ndiag`` ints, ``WT (m, n)`` term-major, data and operand contiguous
    on one CUDA device and of one dtype (float32, float64 or bfloat16).
    Returns ``y (n,)`` in the data dtype, float32 for bfloat16 (products and
    sum in float32).  Raises on anything the kernel does not take - there is
    no fallback to the plain twin."""
    return DiaLauncher(data, offsets).single(WT)


def dia_lincomb_pair(data, offsets, WreT, WimT):
    """One launch for an operand pair: ``(yre, yim)`` with ``yre`` the fused
    apply of the bank to ``WreT`` and ``yim`` to ``WimT`` (both ``(m, n)``),
    the bank read once.  Same contract and refusals as :func:`dia_lincomb`;
    the results equal two single launches bit for bit."""
    return DiaLauncher(data, offsets).pair(WreT, WimT)


def empty_launch(device):
    """Launch the library's empty kernel on ``device``'s current stream (the
    launch floor every call pays; counted nowhere)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_launch needs a CUDA device, got {device}")
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    with torch.cuda.device(index):
        DIA_SPMV.check(DIA_SPMV.load().dia_noop(_raw_stream(index)),
                       "dia_noop")


def shifted_rows(X, off):
    """Rows r of the result = X[r + off], zero where r + off is outside."""
    if off == 0:
        return X
    if abs(off) >= X.shape[0]:
        return torch.zeros_like(X)
    z = torch.zeros((abs(off),) + tuple(X.shape[1:]), dtype=X.dtype,
                    device=X.device)
    if off > 0:
        return torch.cat([X[off:], z], dim=0)
    return torch.cat([z, X[:off]], dim=0)


def dia_lincomb_plain(data, offsets, WT):
    """Plain PyTorch twin of :func:`dia_lincomb`: ``data (m, ndiag, n)``,
    ``offsets`` a sequence of ints, ``WT (m, n)`` term-major.

    Mirrors both branches of ``neptpu.ops.dia.DiaTermBank.lincomb_apply``:
    one shifted product summed over the terms per diagonal for stencil-like
    banks (<= 16 offsets), one padded gather and one reduction for wide
    banks.  bfloat16 inputs are widened to float32 first, as the kernel
    widens them: float32 products and sums, float32 result."""
    if data.dtype == torch.bfloat16:
        data, WT = data.to(torch.float32), WT.to(torch.float32)
    m, _, n = data.shape
    if len(offsets) <= 16:
        W = WT.T  # (n, m) view: rows shift
        y = torch.zeros(n, dtype=WT.dtype, device=WT.device)
        for d, off in enumerate(offsets):
            y = y + torch.sum(data[:, d, :] * shifted_rows(W, off).T, dim=0)
        return y
    offs = np.asarray(offsets)
    lo = int(max(-offs.min(), 0))
    hi = int(max(offs.max(), 0))
    Wp = torch.zeros((m, n + lo + hi), dtype=WT.dtype, device=WT.device)
    Wp[:, lo:lo + n] = WT
    idx = (torch.arange(n, device=WT.device)[None, :]
           + torch.as_tensor(offs + lo, device=WT.device)[:, None])
    return torch.sum(data * Wp[:, idx], dim=(0, 1))  # gather (m, ndiag, n)


def dia_lincomb_pair_plain(data, offsets, WreT, WimT):
    """Plain PyTorch twin of :func:`dia_lincomb_pair`: two plain applies."""
    return (dia_lincomb_plain(data, offsets, WreT),
            dia_lincomb_plain(data, offsets, WimT))
