"""Seconds a solve of the scan's shifted factorization spends on its
Sherman-Morrison-Woodbury correction: the low-rank factors to the device,
X = B^-1 L and the capacitance's inverse (span ``nt.factorize.smw`` in
``build_spmf_shift_solver``), over the profiled solves, on the device's
clock on the card; nothing where the shifted matrix has no low-rank
part."""
from portbench.device_spans import mean_device_seconds


def read(record):
    return mean_device_seconds(record, "nt.factorize.smw")
