"""A scan step replayed as a captured CUDA graph.

The JAX package compiles its scans (``jax.jit`` over ``lax.scan``): every
step has static shapes, the step index ``k`` is traced, and a chunk of steps
is one device program.  The port's scan steps have the same form - static
shapes, ``k`` a 0-dim int64 tensor on the scan's device, read and written
by index ops alone, no host read anywhere in a step - so one captured CUDA
graph serves every ``k``.

:class:`StepGraph` runs such a step ``step(carry, k)`` and advances ``k`` on
the device after it.  On a CUDA device the first step runs eagerly on a side
stream - PyTorch's warm-up before a capture: cuBLAS, cuSOLVER and the kernel
library set up there, and the step it computes is a real one - the second is
captured on that stream, and from the second on every step is one replay of
the graph: one host launch a step.  On the CPU every step runs eagerly.  A
capture or a replay that fails raises; nothing drops to the eager loop.

A graph bakes in what its step reads: Python scalars, the coefficient
tables, the solver's factors, the bank's data and the carry, by address.  So
a graph serves one scan call (one shift) and is freed when the scan returns,
its private memory pool with it.  The step's temporaries come from that pool;
the carry is allocated before and written in place.

The kernel library counts launches on the host, at the launch call
(``DIA_SPMV.counts``); a replay makes no such call.  The launches a capture
records are taken off the counts again (a capture runs nothing) and added
once per replay, so the counts stay the launches the card ran.

``_eager_loop`` runs the scans started inside it as the eager step loop on
the card too: a comparator for the smoke run to time beside the graph, under
a private name, never taken unasked.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch

from ..core import trace
from ..ops.dia_kernel import DIA_SPMV

__all__ = ["StepGraph"]

_EAGER = contextvars.ContextVar("neptpu_torch_eager_scan_loop",
                                default=False)
# one side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace (32 MiB) for each stream it has run on, for the process's life
_STREAMS = {}


def _side_stream(device):
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(index)
    return stream


@contextlib.contextmanager
def _eager_loop():
    """Scans started inside the block run every step eagerly, on the card
    too (the comparator of ``chip_smoke.py``)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


class StepGraph:
    """Runs ``step(carry, k)`` then ``k += 1`` (on ``k``'s device), as many
    times as :meth:`advance` asks; on a CUDA device by replaying one captured
    graph (see the module docstring).  A context manager: leaving it frees
    the graph.  ``eager_steps``, ``replays`` (host graph launches) and
    ``capture_seconds`` say how the steps ran.

    ``capturable=False`` runs every step eagerly on the card too: the
    caller's up-front decision for a step no graph can hold (the sharded
    step over collectives staged through the host)."""

    def __init__(self, step, carry, k, capturable=True):
        self.step, self.carry, self.k = step, carry, k
        self.device = k.device
        self.graphed = (self.device.type == "cuda" and capturable
                        and not _EAGER.get())
        self.graph = None
        self.stream = None
        self.launches = None  # kernel launches recorded by the capture
        self.eager_steps = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self):
        self.step(self.carry, self.k)
        self.k.add_(1)

    def _eager(self):
        if self.graphed:
            cur = torch.cuda.current_stream(self.device)
            self.stream = _side_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self._run()
            cur.wait_stream(self.stream)
        else:
            self._run()
        self.eager_steps += 1

    def _capture(self):
        t0 = time.perf_counter()
        before = DIA_SPMV.snapshot()
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            graph.capture_begin()
            try:
                self._run()
            except BaseException:
                # end the invalidated capture; the step's error is the one
                # to raise
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                DIA_SPMV.add_counts(DIA_SPMV.launches_since(before), -1)
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.launches = DIA_SPMV.launches_since(before)
        DIA_SPMV.add_counts(self.launches, -1)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def advance(self, nsteps):
        """Run ``nsteps`` steps: on the card the first eagerly and the
        capture (span ``nt.scan.capture``), then replays (span
        ``nt.scan.steps`` with the device's time of each run of them,
        counter ``nt.scan.replays``)."""
        nsteps = int(nsteps)
        if not self.graphed:
            for _ in range(nsteps):
                self._eager()
            return
        if nsteps and self.graph is None:
            with trace.span("nt.scan.capture"):
                if not self.eager_steps:
                    self._eager()
                    nsteps -= 1
                if nsteps:
                    self._capture()
        if nsteps:
            with trace.span("nt.scan.steps", device=True):
                for _ in range(nsteps):
                    self.graph.replay()
                    DIA_SPMV.add_counts(self.launches)
            self.replays += nsteps
            trace.count("nt.scan.replays", nsteps)

    def wait(self):
        """Wait for the steps run so far: on the card a replay returns
        before the device has run it, so a host clock reads the steps'
        time only after this."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self):
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None

    def stats(self):
        """How the steps ran: ``graphed``, ``eager_steps``, ``replays``,
        ``capture_s``."""
        return {"graphed": self.graphed, "eager_steps": self.eager_steps,
                "replays": self.replays,
                "capture_s": self.capture_seconds}
