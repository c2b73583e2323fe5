"""Kernels (kernels/qgemm.py, csrc/qgemm.cu): the least time of the
window's W8A8 projections (portbench/work.py ``qgemm_projections`` and the
output head, each the larger of its operations over the int8 peak and its
bytes over the bandwidth, at the live row count), over the device time of
the kernels that ran them in the traced window."""

KERNELS = ("qgemm_kernel", "qgemm_combine")


def read(rec):
    if rec.trace is None:
        return None
    t = rec.trace.device_s(lambda name: any(k in name for k in KERNELS))
    return 100.0 * rec.work.qgemm_least_s / t if t > 0 else None
