"""Mean over the window's solves of the scan's shifted factorization, the
program's own ``t_factorize`` (it synchronizes before reading the clock)."""


def read(record):
    s = record["solves"]
    return sum(x["t_factorize"] for x in s) / len(s) if s else None
