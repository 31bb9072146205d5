"""The 90th percentile, by nearest rank, of the latencies of every solve in
the window."""
import math


def read(record):
    lat = sorted(s["latency_s"] for s in record["window"]["solves"])
    if not lat:
        return None
    return lat[math.ceil(0.9 * len(lat)) - 1]
