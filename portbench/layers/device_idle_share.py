"""Per cent of the traced solves' wall time in which no operation ran on the
device: one less the union of the device intervals over the stretch from
the first traced solve's start to the last one's end."""


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0 or tr["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
