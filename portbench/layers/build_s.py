"""Seconds to build the problem and its term bank (the gallery call and the
bank, ending in a device synchronize): a span of the benchmark's own."""


def read(record):
    return record["build_s"]
