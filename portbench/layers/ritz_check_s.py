"""Mean over the window's solves of the host Ritz checks inside the scan,
the program's own ``t_check``."""


def read(record):
    s = record["solves"]
    return sum(x["t_check"] for x in s) / len(s) if s else None
