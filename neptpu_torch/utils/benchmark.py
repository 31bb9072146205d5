"""Benchmark harness: time named sections, persist JSON records with git and
host metadata, and render a comparison report across runs."""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time

__all__ = ["Benchmarker", "load_history", "render_report"]


def _git_meta(repo="."):
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, cwd=repo).stdout.strip()
        return {"commit": sha[:12]}
    except Exception:
        return {}


class Benchmarker:
    """Collects {name: min_time_s} over repeated runs of callables."""

    def __init__(self, repeats: int = 5):
        self.repeats = repeats
        self.records = {}

    def run(self, name, fn, *args, **kwargs):
        best = float("inf")
        result = None
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            best = min(best, time.perf_counter() - t0)
        self.records[name] = best
        return result

    def save(self, path, extra=None):
        rec = {
            "timestamp": time.time(),
            "host": platform.node(),
            "machine": platform.machine(),
            **_git_meta(os.path.dirname(os.path.abspath(path)) or "."),
            "times": self.records,
        }
        if extra:
            rec.update(extra)
        history = load_history(path)
        history.append(rec)
        with open(path, "w") as f:
            json.dump(history, f, indent=1)
        return rec


def load_history(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def render_report(path, last_n: int = 16):
    """Plain-text trend table over the last runs."""
    hist = load_history(path)[-last_n:]
    if not hist:
        return "(no benchmark history)"
    names = sorted({k for h in hist for k in h.get("times", {})})
    lines = ["benchmark trend (min seconds per run):"]
    header = "name".ljust(32) + " | " + " | ".join(
        h.get("commit", "?")[:8].rjust(9) for h in hist)
    lines.append(header)
    for n in names:
        row = n.ljust(32)[:32] + " | " + " | ".join(
            (f"{h['times'][n]:9.4f}" if n in h.get("times", {})
             else "        -")
            for h in hist)
        lines.append(row)
    return "\n".join(lines)
