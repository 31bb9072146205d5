"""The stacked-DIA fused multi-term SpMV: hand-written CUDA kernel + plain twin.

    y[r] = sum_d sum_i data[i, d, r] * W[r + offsets[d], i]

(W read as zero outside ``[0, n)``).  ``dia_lincomb`` launches the sm_90a
kernel in ``neptpu_torch/csrc/dia_spmv.cu`` (the port of the TPU kernel
``neptpu/ops/pallas_spmv.py``); ``dia_lincomb_pair`` applies one bank to a
re/im operand pair in a single launch that reads the bank once.  Both take
float32 or float64 (result in the data type) and bfloat16 (bank and operands
bfloat16, every product and the whole sum in float32, float32 result — the
TPU kernel's second dtype).  ``dia_lincomb_plain`` and ``dia_lincomb_pair_plain`` are their plain PyTorch
twins, the CPU path and the kernels' test oracle.  The kernel is compiled by
``nvcc`` on first use into ``neptpu_torch/_build/`` (file name keyed by the
source's content hash) and bound through ``ctypes`` with a plain C interface.
Nothing here imports or builds anything at module import time.
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

__all__ = [
    "DIA_SPMV",
    "result_dtype",
    "dia_lincomb",
    "dia_lincomb_pair",
    "dia_lincomb_plain",
    "dia_lincomb_pair_plain",
    "empty_launch",
    "shifted_rows",
    "build_kernel",
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
    type.  ``build_seconds`` and ``build_log`` record the last build."""

    def __init__(self, name, source):
        self.name = name
        self.source = source
        self.counts = {"dia_lincomb": 0, "dia_lincomb_pair": 0}
        self.entry_counts = {f"{entry}_{sfx}": 0 for entry in self.counts
                             for sfx in _SUFFIX.values()}
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._fns = {}  # (entry, dtype) -> bound ctypes function
        self._lock = threading.Lock()

    @property
    def launches(self):
        return sum(self.counts.values())

    def reset_counts(self):
        for counts in (self.counts, self.entry_counts):
            for key in counts:
                counts[key] = 0

    def count(self, entry, dtype):
        """One launch through wrapper ``entry`` with ``dtype`` data."""
        self.counts[entry] += 1
        self.entry_counts[f"{entry}_{_SUFFIX[dtype]}"] += 1

    def library_path(self):
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{digest.hexdigest()[:16]}.so")

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.library_path()
            if not os.path.exists(path):
                self._build(path)
            lib = ctypes.CDLL(path)
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"dia_lincomb_{sfx}")
                fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
                fn.restype = i32
                fn = getattr(lib, f"dia_lincomb_pair_{sfx}")
                fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                               ptr]
                fn.restype = i32
            lib.dia_noop.argtypes = [ptr]
            lib.dia_noop.restype = i32
            lib.dia_error_string.argtypes = [i32]
            lib.dia_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    def function(self, entry, dtype):
        """The bound C entry point ``<entry>_f32``/``_f64``/``_bf16``, looked
        up once per dtype."""
        fn = self._fns.get((entry, dtype))
        if fn is None:
            fn = getattr(self.load(), f"{entry}_{_SUFFIX[dtype]}")
            self._fns[(entry, dtype)] = fn
        return fn

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


def _check_operands(what, data, offsets_dev, operands):
    """Raise on anything the kernels do not take; returns ``(m, ndiag, n)``.
    ``operands``: ``(name, tensor)`` pairs, each an ``(n, m)`` operand."""
    dev, dt = data.device, data.dtype
    for name, t in (("data", data), ("offsets", offsets_dev)) + operands:
        if t.device != dev or dev.type != "cuda":
            if t.device.type != "cuda":
                raise ValueError(f"{what} kernel needs CUDA tensors; {name} "
                                 f"is on {t.device}")
            raise ValueError(f"{what}: data, offsets and operands on "
                             "different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous {name}")
    if dt not in _SUFFIX or offsets_dev.dtype != torch.int32:
        raise TypeError(f"{what} kernel takes float32, float64 or bfloat16 "
                        f"data with int32 offsets, got {dt} and "
                        f"{offsets_dev.dtype}")
    if data.ndim != 3 or offsets_dev.ndim != 1:
        raise ValueError(f"{what}: data (m, ndiag, n), offsets (ndiag,)")
    m, ndiag, n = data.shape
    if offsets_dev.shape[0] != ndiag:
        raise ValueError(f"{what}: {offsets_dev.shape[0]} offsets for "
                         f"{ndiag} diagonals")
    for name, W in operands:
        if W.dtype != dt:
            raise TypeError(f"{what} kernel takes data and operands of one "
                            f"dtype, got {dt} and {W.dtype} ({name})")
        if W.shape != (n, m):
            raise ValueError(f"{what}: {name} has shape {tuple(W.shape)}, "
                             f"data {tuple(data.shape)} needs ({n}, {m})")
    return m, ndiag, n


def _on_stream(device, call):
    """``call(raw_stream)`` with ``device`` current, on its current stream;
    the current device is switched only when it is another one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream(device).cuda_stream)


def dia_lincomb(data, offsets_dev, W):
    """Launch the CUDA kernel: ``data (m, ndiag, n)``, ``offsets_dev (ndiag,)``
    int32, ``W (n, m)``, all contiguous on one CUDA device, float32, float64
    or bfloat16 (data and operand of one dtype).  Returns ``y (n,)`` in the
    data dtype, float32 for bfloat16 (products and sum in float32).  Raises
    on anything the kernel does not take — there is no fallback to the plain
    twin."""
    m, ndiag, n = _check_operands("dia_lincomb", data, offsets_dev,
                                  (("W", W),))
    fn = DIA_SPMV.function("dia_lincomb", data.dtype)
    y = torch.empty(n, dtype=result_dtype(data.dtype), device=data.device)
    rc = _on_stream(data.device, lambda stream: fn(
        data.data_ptr(), offsets_dev.data_ptr(), W.data_ptr(), y.data_ptr(),
        n, m, ndiag, stream))
    DIA_SPMV.check(rc, "dia_lincomb")
    DIA_SPMV.count("dia_lincomb", data.dtype)
    return y


def dia_lincomb_pair(data, offsets_dev, Wre, Wim):
    """One launch for an operand pair: ``(yre, yim)`` with ``yre`` the fused
    apply of the bank to ``Wre`` and ``yim`` to ``Wim`` (both ``(n, m)``), the
    bank read once.  Same contract and refusals as :func:`dia_lincomb`; the
    results equal two single launches bit for bit."""
    m, ndiag, n = _check_operands("dia_lincomb_pair", data, offsets_dev,
                                  (("Wre", Wre), ("Wim", Wim)))
    fn = DIA_SPMV.function("dia_lincomb_pair", data.dtype)
    y = torch.empty((2, n), dtype=result_dtype(data.dtype),
                    device=data.device)
    yre_ptr = y.data_ptr()
    rc = _on_stream(data.device, lambda stream: fn(
        data.data_ptr(), offsets_dev.data_ptr(), Wre.data_ptr(),
        Wim.data_ptr(), yre_ptr, yre_ptr + n * y.element_size(), n, m, ndiag,
        stream))
    DIA_SPMV.check(rc, "dia_lincomb_pair")
    DIA_SPMV.count("dia_lincomb_pair", data.dtype)
    return y[0], y[1]


def empty_launch(device):
    """Launch the library's empty kernel on ``device``'s current stream (the
    launch floor every call pays; counted nowhere)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_launch needs a CUDA device, got {device}")
    DIA_SPMV.check(_on_stream(device, DIA_SPMV.load().dia_noop), "dia_noop")


def shifted_rows(X, off):
    """Rows r of the result = X[r + off], zero where r + off is outside."""
    if off == 0:
        return X
    z = torch.zeros((abs(off),) + tuple(X.shape[1:]), dtype=X.dtype,
                    device=X.device)
    if off > 0:
        return torch.cat([X[off:], z], dim=0)
    return torch.cat([z, X[:off]], dim=0)


def dia_lincomb_plain(data, offsets, W):
    """Plain PyTorch twin of :func:`dia_lincomb` (offsets a tuple of ints).

    Mirrors both branches of ``neptpu.ops.dia.DiaTermBank.lincomb_apply``:
    unrolled shifted FMAs for stencil-like banks (<= 16 offsets), one padded
    gather + einsum for wide banks.  bfloat16 inputs are widened to float32
    first, as the kernel widens them: float32 products and sums, float32
    result."""
    if data.dtype == torch.bfloat16:
        data, W = data.to(torch.float32), W.to(torch.float32)
    n = data.shape[2]
    if len(offsets) <= 16:
        y = torch.zeros(n, dtype=W.dtype, device=W.device)
        for d, off in enumerate(offsets):
            y = y + torch.sum(data[:, d, :].T * shifted_rows(W, off), dim=1)
        return y
    offs = np.asarray(offsets)
    lo = int(max(-offs.min(), 0))
    hi = int(max(offs.max(), 0))
    Wp = torch.zeros((n + lo + hi, W.shape[1]), dtype=W.dtype, device=W.device)
    Wp[lo:lo + n] = W
    idx = (torch.arange(n, device=W.device)[:, None]
           + torch.as_tensor(offs + lo, device=W.device)[None, :])
    G = Wp[idx]  # (n, ndiag, m)
    return torch.einsum("idr,rdi->r", data, G)


def dia_lincomb_pair_plain(data, offsets, Wre, Wim):
    """Plain PyTorch twin of :func:`dia_lincomb_pair`: two plain applies."""
    return (dia_lincomb_plain(data, offsets, Wre),
            dia_lincomb_plain(data, offsets, Wim))
