"""Seconds from the start of the process to the first timed solve: the
library load (or build), the problem and its bank, the reference and the
warm-up solve."""


def read(record):
    return record["window"]["setup_s"]
