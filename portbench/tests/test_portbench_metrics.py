"""The end-to-end arithmetic, the frozen roofline bound and the reading of a
profiler trace, on synthetic inputs."""
import os

import pytest

from portbench.harness import analyse_trace, judge, load_module
from portbench.measures import bound, busy_intervals

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(folder, name):
    return load_module(os.path.join(BASE, folder, f"{name}.py"), folder)


def window(latencies, t_end):
    return {"window": {"t_start": 10.0, "t_end": 10.0 + t_end,
                       "setup_s": 3.5,
                       "solves": [{"latency_s": x} for x in latencies]}}


def test_solve_s_is_the_window_over_the_solves():
    rec = window([1.0, 2.0, 3.0, 4.0], 10.4)
    assert metric("end_to_end", "solve_s").read(rec) == pytest.approx(2.6)
    assert metric("end_to_end", "setup_s").read(rec) == 3.5


@pytest.mark.parametrize("n, rank", [(1, 1), (9, 9), (10, 9), (11, 10),
                                     (20, 18), (21, 19)])
def test_p90_is_the_nearest_rank(n, rank):
    lat = [float(i) for i in range(n, 0, -1)]  # n .. 1, unsorted order
    assert metric("end_to_end", "solve_p90_s").read(window(lat, 1.0)) == rank


def test_bound_reproduces_the_kernel_table():
    # PERF.md section 6: headline f32 single 48.96 us, gun_like f32 pair 0.190
    ms, by, _ = bound(1_000_000, 4, 9, 1, 4, "float32")
    assert (round(ms * 1e3, 2), by) == (48.96, "bytes")
    ms, by, _ = bound(9956, 2, 5, 2, 4, "float32")
    assert (round(ms * 1e3, 3), by) == (0.190, "bytes")


def trace():
    """A solve of 1000 us: a scan span over its first 600, an ``aten::mm``
    from 300 to 550, and device work at 100-120 (B1, then a GEMM) and
    700-800; one kernel outside the solve."""
    return [
        {"cat": "user_annotation", "name": "solve", "ts": 0, "dur": 1000},
        {"cat": "user_annotation", "name": "scan", "ts": 0, "dur": 600},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 300, "dur": 250},
        {"cat": "kernel", "name": "void dia_lincomb_pair_kernel<float, 2, "
         "1, Offs>(Offs, float const*)", "ts": 100, "dur": 2},
        {"cat": "kernel", "name": "gemm", "ts": 102, "dur": 18},
        {"cat": "kernel", "name": "gemm", "ts": 700, "dur": 100},
        {"cat": "kernel", "name": "late", "ts": 1500, "dur": 10}]


def test_trace_busy_gaps_and_b1():
    tr = analyse_trace(trace())
    assert tr["window_s"] == pytest.approx(1000e-6)
    assert tr["busy_s"] == pytest.approx(120e-6)     # [100, 120], [700, 800]
    gaps = dict(tr["idle_gaps"])
    # 0-100 and 120-700 (middle 410: inside aten::mm), 800-1000 (the solve)
    assert gaps == pytest.approx({"scan": 100e-6, "aten::mm": 580e-6,
                                  "solve": 200e-6})
    assert dict(tr["device_ops"])["gemm"] == pytest.approx(118e-6)
    assert tr["b1"] == [(trace()[3]["name"], 2)]
    assert busy_intervals([{"ts": 0, "dur": 5}, {"ts": 3, "dur": 5}]) == [(0, 8)]


def test_layer_readers():
    tr = analyse_trace(trace())
    rec = {"trace": tr, "b1_shape": (9956, 2, 5), "build_s": 1.5,
           "solves": [{"t_factorize": 0.2, "t_scan": 0.3, "t_check": 0.1,
                       "k_done": 40, "t_refine": None},
                      {"t_factorize": 0.4, "t_scan": 0.5, "t_check": 0.1,
                       "k_done": 60, "t_refine": None}]}
    read = {name: metric("layers", name).read(rec) for name in (
        "build_s", "factorize_s", "scan_step_ms", "ritz_check_s", "refine_s",
        "b1_roofline", "device_idle_share")}
    assert read["build_s"] == 1.5
    assert read["factorize_s"] == pytest.approx(0.3)
    assert read["scan_step_ms"] == pytest.approx(1e3 * 0.6 / 100)
    assert read["ritz_check_s"] == pytest.approx(0.1)
    assert read["refine_s"] is None
    assert read["b1_roofline"] == pytest.approx(100 * 0.19018 / 2, rel=1e-3)
    assert read["device_idle_share"] == pytest.approx(88.0)
    rec["trace"] = None
    assert metric("layers", "b1_roofline").read(rec) is None
    assert metric("layers", "device_idle_share").read(rec) is None


class _Ref:
    def backward(self, lams, Q):
        return abs(lams.imag)


def test_judge_counts_short_and_claimed():
    import numpy as np

    good = (np.array([1 + 1e-9j, 2 + 2e-9j]), np.zeros((3, 2)),
            np.array([1e-9, 2e-9]))
    short = (np.array([1 + 1e-9j, 1 + 1e-9j]), np.zeros((3, 2)),
             np.array([1e-9, 1e-9]))
    lied = (np.array([1 + 1e-3j, 2 + 1e-9j]), np.zeros((3, 2)),
            np.array([1e-9, 1e-9]))
    c = judge(_Ref(), [good, short], 1e-6, 2)
    assert c["short_share"] == 0.5 and c["backward_max"] == 2e-9
    assert c["floor_median"] == pytest.approx(1e-9)
    assert judge(_Ref(), [lied], 1e-6, 2)["backward_max"] == 1e-3
    assert judge(_Ref(), [], 1e-6, 2)["floor_median"] is None
