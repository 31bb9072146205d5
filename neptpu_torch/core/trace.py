"""Spans and counters of one request, in memory, and the process's load.

A request is the block under :func:`collect`: every :func:`span` entered in
it (in any function it calls) records its name, its parent - the span that
encloses it - and its start and end on ``time.perf_counter_ns``; with
``device=True`` a span also records a pair of CUDA events on the current
stream, read only when the collector closes, so a span adds no
synchronize.  :func:`count` adds to a named counter.  Every name starts with
``nt.``.

While the torch profiler records, each span also enters
``torch.profiler.record_function(name)``: the program's spans then sit on
the kernels' clock in the profiler's chrome trace, around the idle gaps of
the device they cause.  Spans and counts of code run under the profiler
outside any :func:`collect` go to the process's profile collector
(:func:`profiled`), so a profiled run carries the same split.

With neither a collector nor the profiler, :func:`span` returns one shared
no-op and :func:`count` returns at once: a context-variable read and a flag
read, nothing allocated.  :func:`clock` is the span whose ``seconds`` the
caller reads (the solvers' ``info["t_scan"]`` and its kin): it reads the
clock always and records where a span would.

:func:`load_totals` holds what the process paid once, outside any request:
the import of ``neptpu_torch`` (``nt.load.import``) and the load, or build,
of the kernel library (``nt.load.kernel_library``).

    with neptpu_torch.trace.collect() as c:
        lams, Q = neptpu_torch.iar_real_spmf(nep, sigma=s, ...)
    c.totals()["nt.factorize.assemble"]["seconds"], c.counters()
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Collector", "collect", "span", "clock", "count", "profiled",
           "load_span", "load_totals"]

_ACTIVE = contextvars.ContextVar("neptpu_torch_trace", default=None)
# the innermost open span of this context: (collector, its record index)
_OPEN = contextvars.ContextVar("neptpu_torch_trace_open", default=None)

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling():
        return _autograd_profiler._is_profiler_enabled
else:  # builds that keep only the C-level flag
    _profiling = torch._C._autograd._profiler_enabled


class Collector:
    """The spans and counters of one request (:func:`collect`), or of the
    code run under the profiler outside any request (:func:`profiled`).

    A span record is ``[name, parent, start_ns, end_ns, device]``: ``parent``
    the index of the enclosing span's record in this collector (None at the
    top), ``end_ns`` None while open, ``device`` None, a pair of CUDA
    events not yet read, or the milliseconds between them."""

    def __init__(self):
        self._spans = []
        self._counters = {}

    def _resolve(self):
        for rec in self._spans:
            ev = rec[4]
            if isinstance(ev, tuple) and rec[3] is not None:
                ev[1].synchronize()
                rec[4] = ev[0].elapsed_time(ev[1])

    def spans(self):
        """The closed spans, in the order they opened: dicts of ``name``,
        ``parent`` (index into this list, or None), ``start_ns``,
        ``end_ns`` and ``device_ms`` (None where no events were
        recorded)."""
        self._resolve()
        index, out = {}, []
        for i, (name, parent, t0, t1, dev) in enumerate(self._spans):
            if t1 is None:
                continue
            index[i] = len(out)
            out.append({"name": name, "parent": index.get(parent),
                        "start_ns": t0, "end_ns": t1, "device_ms": dev})
        return out

    def totals(self):
        """For each span name: ``seconds`` (summed duration),
        ``self_seconds`` (duration less what its child spans cover),
        ``calls``, and ``device_ms`` where the spans recorded events."""
        recs = self.spans()
        child = [0] * len(recs)
        for r in recs:
            if r["parent"] is not None:
                child[r["parent"]] += r["end_ns"] - r["start_ns"]
        out = {}
        for r, c in zip(recs, child):
            dur = r["end_ns"] - r["start_ns"]
            t = out.setdefault(r["name"], {"seconds": 0.0,
                                           "self_seconds": 0.0, "calls": 0})
            t["seconds"] += dur * 1e-9
            t["self_seconds"] += (dur - c) * 1e-9
            t["calls"] += 1
            if r["device_ms"] is not None:
                t["device_ms"] = t.get("device_ms", 0.0) + r["device_ms"]
        return out

    def counters(self):
        """The counters, by name."""
        return dict(self._counters)

    def clear(self):
        """Forget every span and counter recorded so far."""
        self._spans.clear()
        self._counters.clear()


class _Noop:
    """The span of code that nobody traces."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_PROFILED = Collector()


class _Span:
    """A span being recorded into ``col`` (None: only its clock is read,
    :func:`clock`), under ``record_function`` where ``prof``."""

    __slots__ = ("col", "name", "device", "prof", "seconds", "_t0", "_ev",
                 "_rf", "_rec", "_token")

    def __init__(self, col, name, device, prof):
        self.col, self.name, self.device, self.prof = col, name, device, prof
        self.seconds = 0.0

    def __enter__(self):
        if self.prof:
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        col = self.col
        if col is not None:
            opened = _OPEN.get()
            parent = (opened[1] if opened is not None and opened[0] is col
                      else None)
            self._rec = [self.name, parent, 0, None, None]
            self._token = _OPEN.set((col, len(col._spans)))
            col._spans.append(self._rec)
            if self.device:
                self._ev = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                self._ev[0].record()
        self._t0 = time.perf_counter_ns()
        if col is not None:
            self._rec[2] = self._t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        if self.col is not None:
            if self.device:
                self._ev[1].record()
                self._rec[4] = self._ev
            self._rec[3] = t1
            _OPEN.reset(self._token)
        if self.prof:
            self._rf.__exit__(*exc)
        return False


def span(name, device=False):
    """A context manager recording the span ``name`` where a collector or
    the profiler is active, else the shared no-op.  ``device=True``: also a
    pair of CUDA events on the current stream around the block (pass it only
    where the block's work runs on the card)."""
    col = _ACTIVE.get()
    prof = _profiling()
    if col is None:
        if not prof:
            return _NOOP
        col = _PROFILED
    return _Span(col, name, device, prof)


def clock(name):
    """:func:`span` whose ``seconds``, the block's host time, is read
    always (set on leaving the block)."""
    col = _ACTIVE.get()
    prof = _profiling()
    if col is None and prof:
        col = _PROFILED
    return _Span(col, name, False, prof)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` of the active collector (the
    profile collector under the profiler); nothing where neither is
    active."""
    col = _ACTIVE.get()
    if col is None:
        if not _profiling():
            return
        col = _PROFILED
    col._counters[name] = col._counters.get(name, 0) + n


@contextlib.contextmanager
def collect():
    """Collect the spans and counters of one request: yields the
    :class:`Collector`; its device events are read as the block ends."""
    col = Collector()
    token = _ACTIVE.set(col)
    try:
        yield col
    finally:
        _ACTIVE.reset(token)
        col._resolve()


def profiled():
    """The process's profile collector: the spans and counters recorded
    under the torch profiler outside any :func:`collect` (``clear()`` it to
    start anew)."""
    return _PROFILED


_LOAD = {}


def _add_load(name, ns):
    t = _LOAD.setdefault(name, {"seconds": 0.0, "calls": 0})
    t["seconds"] += ns * 1e-9
    t["calls"] += 1


@contextlib.contextmanager
def load_span(name):
    """Time a one-off load of the process into :func:`load_totals`."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _add_load(name, time.perf_counter_ns() - t0)


def load_totals():
    """What the process paid once, by span name: ``seconds`` and
    ``calls``."""
    return {name: dict(t) for name, t in _LOAD.items()}
