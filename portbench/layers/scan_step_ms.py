"""Milliseconds a scan step without the host Ritz checks: the program's
``t_scan`` less ``t_check``, summed over the window's solves, over their
summed ``k_done``."""


def read(record):
    s = record["solves"]
    steps = sum(x["k_done"] for x in s)
    if not steps:
        return None
    return 1e3 * sum(x["t_scan"] - x["t_check"] for x in s) / steps
