"""Seconds a solve: from the window's start to the end of its last solve,
over the number of solves."""


def read(record):
    w = record["window"]
    if not w["solves"]:
        return None
    return (w["t_end"] - w["t_start"]) / len(w["solves"])
