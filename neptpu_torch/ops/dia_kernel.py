"""The stacked-DIA fused multi-term SpMV: hand-written CUDA kernel + plain twin.

    y[r] = sum_d sum_i data[i, d, r] * W[r + offsets[d], i]

(W read as zero outside ``[0, n)``).  ``dia_lincomb`` launches the sm_90a
kernel in ``neptpu_torch/csrc/dia_spmv.cu`` (the port of the TPU kernel
``neptpu/ops/pallas_spmv.py``); ``dia_lincomb_plain`` is its plain PyTorch
twin, the CPU path and the kernel's test oracle.  The kernel is compiled by
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
    "dia_lincomb",
    "dia_lincomb_plain",
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


class KernelLibrary:
    """One CUDA source built into a shared library on first use.

    ``launches`` counts kernel launches made through the wrapper (and only
    there); ``build_seconds`` and ``build_log`` record the last build."""

    def __init__(self, name, source):
        self.name = name
        self.source = source
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

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
            for fn in (lib.dia_lincomb_f32, lib.dia_lincomb_f64):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.dia_error_string.argtypes = [ctypes.c_int]
            lib.dia_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

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


def dia_lincomb(data, offsets_dev, W):
    """Launch the CUDA kernel: ``data (m, ndiag, n)``, ``offsets_dev (ndiag,)``
    int32, ``W (n, m)``, all contiguous on one CUDA device, float32 or float64
    (one dtype).  Returns ``y (n,)``.  Raises on anything the kernel does not
    take — there is no fallback to the plain twin."""
    for name, t in (("data", data), ("offsets", offsets_dev), ("W", W)):
        if t.device.type != "cuda":
            raise ValueError(f"dia_lincomb kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"dia_lincomb kernel needs contiguous {name}")
    if not (data.device == offsets_dev.device == W.device):
        raise ValueError("dia_lincomb: data, offsets and W on different "
                         "devices")
    if (data.dtype not in (torch.float32, torch.float64)
            or W.dtype != data.dtype):
        raise TypeError(f"dia_lincomb kernel takes float32 or float64 data "
                        f"and W of one dtype, got {data.dtype} and {W.dtype}")
    if offsets_dev.dtype != torch.int32:
        raise TypeError("dia_lincomb kernel needs int32 offsets")
    if data.ndim != 3 or W.ndim != 2 or offsets_dev.ndim != 1:
        raise ValueError("dia_lincomb: data (m, ndiag, n), W (n, m), offsets "
                         "(ndiag,)")
    m, ndiag, n = data.shape
    if tuple(W.shape) != (n, m) or offsets_dev.shape[0] != ndiag:
        raise ValueError(f"dia_lincomb: shapes data {tuple(data.shape)}, "
                         f"W {tuple(W.shape)}, offsets "
                         f"{tuple(offsets_dev.shape)} do not match")
    lib = DIA_SPMV.load()
    fn = (lib.dia_lincomb_f32 if data.dtype == torch.float32
          else lib.dia_lincomb_f64)
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), offsets_dev.data_ptr(), W.data_ptr(),
                y.data_ptr(), n, m, ndiag, stream)
    if rc != 0:
        raise RuntimeError(f"dia_lincomb kernel launch failed: "
                           f"{lib.dia_error_string(rc).decode()} ({rc})")
    DIA_SPMV.launches += 1
    return y


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
    gather + einsum for wide banks."""
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
