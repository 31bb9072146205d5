"""Levelled solver logging (reference ``src/logger.jl``).

``PrintLogger(displaylevel)`` prints progress; ``ErrorLogger`` stores the full
per-iteration error history into a matrix — the convergence-curve instrument
(reference ``logger.jl:94-132``).  Solvers accept ``logger=<int>`` as shorthand
for ``PrintLogger(<int>)`` (the reference's ``@parse_logger_param!``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["Logger", "PrintLogger", "ErrorLogger", "parse_logger",
           "push_info", "push_iteration_info"]


def push_info(logger, msg, level: int = 1):
    """Module-level form of the reference's ``push_info!`` (``logger.jl``)."""
    parse_logger(logger).info(msg, level=level)


def push_iteration_info(logger, iter_idx, errs=None, lams=None, level: int = 1):
    """Module-level form of the reference's ``push_iteration_info!``."""
    parse_logger(logger).iteration(iter_idx, errs=errs, lams=lams, level=level)


class Logger:
    def info(self, msg, level: int = 1):  # push_info!
        pass

    def iteration(self, iter_idx, errs=None, lams=None, level: int = 1):
        # push_iteration_info!
        pass


class PrintLogger(Logger):
    def __init__(self, displaylevel: int = 0):
        self.displaylevel = displaylevel

    def info(self, msg, level: int = 1):
        if self.displaylevel >= level:
            print(msg)

    def iteration(self, iter_idx, errs=None, lams=None, level: int = 1):
        if self.displaylevel >= level:
            e = None
            if errs is not None:
                e = np.atleast_1d(np.asarray(errs))
                e = float(np.min(e)) if e.size else None
            l = None
            if lams is not None:
                l = np.atleast_1d(np.asarray(lams))
                l = complex(l[0]) if l.size else None
            print(f"iter {iter_idx} err={e} lam={l}")


class ErrorLogger(Logger):
    """Records errs[iter, j] for every Ritz value j (NaN = absent)."""

    def __init__(self, maxits: int = 1000, maxvals: int = 100, displaylevel: int = 0):
        self.errs = np.full((maxits, maxvals), np.nan)
        self.printlogger = PrintLogger(displaylevel)

    def info(self, msg, level: int = 1):
        self.printlogger.info(msg, level)

    def iteration(self, iter_idx, errs=None, lams=None, level: int = 1):
        if errs is not None and 0 <= iter_idx < self.errs.shape[0]:
            e = np.atleast_1d(np.asarray(errs, dtype=float))
            m = min(e.size, self.errs.shape[1])
            self.errs[iter_idx, :m] = e[:m]
        self.printlogger.iteration(iter_idx, errs=errs, lams=lams, level=level)


def parse_logger(logger) -> Logger:
    if logger is None:
        return PrintLogger(0)
    if isinstance(logger, int):
        return PrintLogger(logger)
    return logger
