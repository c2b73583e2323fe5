"""Kernels (kernels/paged_attention.py, csrc/paged_attention.cu): the byte
bound of the window's decode attention (every live cached K and V read
once per layer, plus the query and output rows; portbench/work.py), over
the device time of the paged-attention kernels inside the decode
instructions of the traced window (prefill runs the same kernels and is
left out of both sides)."""

KERNELS = ("paged_attention_split", "paged_attention_combine")


def read(rec):
    if rec.trace is None:
        return None
    t = rec.trace.device_s(lambda name: any(k in name for k in KERNELS), phase="opq:decode")
    return 100.0 * rec.work.decode_attn_least_s / t if t > 0 else None
