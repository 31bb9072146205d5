"""Mean seconds of the Newton refinement a solve, a span of the benchmark's
own around ``newton_refine`` (which returns host arrays); nothing where the
traffic refines nothing."""


def read(record):
    t = [x["t_refine"] for x in record["solves"] if x["t_refine"] is not None]
    return sum(t) / len(t) if t else None
