"""Dtype and device policy and matmul precision for the PyTorch port.

Every solver takes an explicit ``dtype``; nothing here changes PyTorch's
global default dtype.  ``device=None`` at an entry point means the card
(:func:`default_device`), or the device of a bank or tensor the caller handed
in; a CPU run asks for ``device="cpu"``.  Float32 products on an NVIDIA card must run
in full float32: TF32 keeps about three decimal digits and raises the Krylov
noise floor the same way the TPU's single-pass bf16 products did (the JAX
package asks for ``precision="highest"`` there).  So TF32 is switched off for
matmuls and cuDNN when this module is imported.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "default_device",
    "resolve_device",
    "default_real",
    "default_complex",
    "complex_of",
    "real_of",
    "result_type",
    "to_torch_dtype",
    "to_numpy_dtype",
    "finfo_max",
]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def default_device():
    """The device of an entry point called with ``device=None``: the card.
    Without one this raises — the port never moves to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "neptpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None, like=None):
    """``device`` if given, else the device of ``like`` (a tensor, a term
    bank or a solver exposing ``.device``) if given, else the card."""
    if device is not None:
        return torch.device(device)
    if like is not None:
        return torch.device(like.device)
    return default_device()


def default_real():
    """The real dtype of reference-accuracy runs (float64)."""
    return torch.float64


def default_complex():
    """The complex dtype of reference-accuracy runs (complex128)."""
    return torch.complex128


def to_torch_dtype(dtype):
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def to_numpy_dtype(dtype):
    """The numpy dtype matching a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def complex_of(dtype):
    """The complex dtype with the same precision as ``dtype``."""
    dtype = to_torch_dtype(dtype)
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def real_of(dtype):
    """The real dtype with the same precision as ``dtype``."""
    dtype = to_torch_dtype(dtype)
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


def result_type(*args):
    """Promotion over tensors and dtypes (``torch.promote_types`` folded)."""
    out = None
    for a in args:
        dt = a.dtype if isinstance(a, torch.Tensor) else to_torch_dtype(a)
        out = dt if out is None else torch.promote_types(out, dt)
    return out


def finfo_max(dtype):
    """Largest finite value of a real or complex dtype."""
    return float(torch.finfo(real_of(dtype)).max)
