"""W8A8 int8 GEMM: the CUDA kernel ``csrc/qgemm.cu`` and its plain version.

Replaces ``repro/kernels/qgemm.py::qgemm`` and, in the port, the XLA int8
``dot_general`` of ``models/layers.py::pdot``, which ``torch.matmul`` cannot
run on CUDA. Contract::

    qgemm(a_q, b_q, sb, sa=None, out_dtype=torch.float32)
      = (float(a_q @ b_q  accumulated in int32) * (sa[m] * sb[n])).to(out_dtype)

with the scale product taken first (pdot's order) and ``sa`` left out when
None, which makes ``sa=None`` with f32 output exactly the Pallas kernel's
function. ``a_q`` is (M, K) int8, ``b_q`` (K, N) int8 in its public layout,
``sb`` (N,) f32, ``sa`` (M,) f32. Ragged M, N and K are masked in the kernel;
the Pallas kernel asserted block alignment instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def qgemm_plain(a_q: torch.Tensor, b_q: torch.Tensor, sb: torch.Tensor,
                sa: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version. The operands are widened before the product:
    a CPU int8 matmul returns int8 and wraps. CUDA has no integer matmul, so
    there the product runs in float64, which holds every partial sum exactly
    (|sum| <= K * 127^2 < 2^53)."""
    if a_q.device.type == "cpu":
        acc = a_q.to(torch.int32) @ b_q.to(torch.int32)
    else:
        acc = (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)
    scale = sb if sa is None else sa[:, None] * sb[None, :]
    return (acc.to(torch.float32) * scale).to(out_dtype)


def _check(a_q, b_q, sb, sa, out_dtype) -> None:
    for name, t, dt in (("a_q", a_q, torch.int8), ("b_q", b_q, torch.int8),
                        ("sb", sb, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qgemm: {name} must be {dt}, got {t.dtype}")
    if a_q.ndim != 2 or b_q.ndim != 2 or sb.ndim != 1:
        raise ValueError(f"qgemm: expected a_q (M,K), b_q (K,N), sb (N,); got "
                         f"{tuple(a_q.shape)}, {tuple(b_q.shape)}, {tuple(sb.shape)}")
    M, K = a_q.shape
    K2, N = b_q.shape
    if K != K2 or sb.shape[0] != N or min(M, N, K) < 1:
        raise ValueError(f"qgemm: shape mismatch {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)} with sb {tuple(sb.shape)}")
    if K * 127 * 127 >= 2 ** 31:
        raise ValueError(f"qgemm: contraction dim {K} would overflow int32")
    if sa is not None and (sa.dtype != torch.float32 or sa.shape != (M,)):
        raise ValueError(f"qgemm: sa must be f32 ({M},), got {sa.dtype} "
                         f"{tuple(sa.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qgemm: out_dtype must be one of {_OUT_DTYPES}")
    tensors = [a_q, b_q, sb] + ([sa] if sa is not None else [])
    if any(t.device != a_q.device for t in tensors):
        raise ValueError("qgemm: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qgemm: operands must be contiguous")


def qgemm(a_q: torch.Tensor, b_q: torch.Tensor, sb: torch.Tensor,
          sa: Optional[torch.Tensor] = None,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """See module docstring. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream."""
    _check(a_q, b_q, sb, sa, out_dtype)
    if a_q.device.type == "cpu":
        return qgemm_plain(a_q, b_q, sb, sa, out_dtype)
    if a_q.device.type != "cuda":
        raise ValueError(f"qgemm: unsupported device {a_q.device}")
    M, K = a_q.shape
    N = b_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    lib = _build.library("qgemm")
    err = lib.qgemm_launch(
        a_q.data_ptr(), b_q.data_ptr(), sb.data_ptr(),
        sa.data_ptr() if sa is not None else None, out.data_ptr(),
        M, N, K, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(a_q.device).cuda_stream)
    _build.check(err, "qgemm")
    qgemm.launches += 1
    return out


qgemm.launches = 0
