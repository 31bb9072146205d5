"""The benchmark's own copies of the measures it shares with the port's
smoke script.  They are frozen here so that a change to the program cannot
move the yardstick; each names where it was copied from.
"""
from __future__ import annotations

import json

import numpy as np
import torch

# published peaks of one NVIDIA H100 SXM at its 700 W limit (chip_smoke.py:250-252)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}


def errmeasure(ref):
    """A user's ``(lam, q) -> backward error`` callable over the plain
    reference's own matrices, with the batched form under ``.batch`` that
    ``newton_refine`` looks for (chip_smoke.py:280-300, bench.py:123-147:
    the same measure; the vector is normalised here).  A vector on the card
    is copied to the host first."""

    def err(lam, q):
        if isinstance(q, torch.Tensor):
            q = q.detach().cpu().resolve_conj()
        return float(ref.backward([lam], np.asarray(q)[:, None])[0])

    err.batch = ref.backward
    return err


def cluster_candidates(lams, errs, rel=3e-5, keep=None):
    """One best-residual representative per eigenvalue cluster
    (chip_smoke.py:303-310)."""
    sel = []
    for j in np.argsort(errs):
        if all(abs(lams[j] - lams[i]) > rel * max(1.0, abs(lams[j]))
               for i in sel):
            sel.append(int(j))
    return sel[:keep] if keep is not None else sel


def distinct_below_tol(lams, errs, tol, rel=1e-7):
    """Distinct eigenpairs below ``tol`` (best residual per 1e-7 group)
    (chip_smoke.py:313-322)."""
    good = np.nonzero(np.asarray(errs) < tol)[0]
    sel = []
    for j in good[np.argsort(np.asarray(errs)[good])]:
        if all(abs(lams[j] - lams[i]) > rel * max(1.0, abs(lams[j]))
               for i in sel):
            sel.append(int(j))
    return sel


def bound(n, m, ndiag, noperands, itemsize, dtype_name):
    """Least time (ms) for the fused apply of one (m, ndiag, n) bank to
    ``noperands`` (n, m) operands: each input read once, each output written
    once (the bfloat16 kernels write float32), against the published memory
    rate; 2 flops per bank word and operand against the published vector
    rate.  Returns (ms, by, bytes) (chip_smoke.py:375-388)."""
    out_size = 4 if dtype_name == "bfloat16" else itemsize
    nbytes = ((m * ndiag * n + noperands * n * m) * itemsize
              + noperands * n * out_size)
    flops = 2 * m * ndiag * n * noperands
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((t_bytes, "bytes", nbytes) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes))


def trace_events(trace_path):
    """All events of a chrome trace written by ``torch.profiler``."""
    with open(trace_path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_events(events):
    """The device operations (kernels, copies, memsets) among a trace's
    events (chip_smoke.py:2157-2164)."""
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_intervals(dev):
    """The union of the device operations' intervals, as sorted disjoint
    ``(start, end)`` pairs in microseconds (the sum that chip_smoke.py:2306
    ``_busy`` takes)."""
    out = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
