"""Seconds a solve of the shifted factorization's host assembly (span
``nt.factorize.assemble``: the SPIKE + SMW parts and their interleaving,
or the sparse sum of a dense LU), over the profiled solves."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.factorize.assemble")
