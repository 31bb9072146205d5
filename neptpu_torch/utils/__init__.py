"""Utilities: serialization, benchmark harness, extended precision."""
from .serialization import read_sparse_matrix, write_sparse_matrix
from .benchmark import Benchmarker, load_history, render_report
from .extended import MPNEP, augnewton_mp, mp_from_nep, newton_mp, resnorm_mp

__all__ = [
    "read_sparse_matrix", "write_sparse_matrix",
    "Benchmarker", "load_history", "render_report",
    "MPNEP", "mp_from_nep", "newton_mp", "augnewton_mp", "resnorm_mp",
]
