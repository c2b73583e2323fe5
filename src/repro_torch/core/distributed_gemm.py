"""Pod-scale tpuGemm on one card: the port of ``repro.core.distributed_gemm``.

The reference lays the paper's multi-accelerator GEMM (Fig. 8) on a
production mesh: M-rows over ``data``, N-columns over ``model``, every chip
owning an (M/16 x N/16) output tile (2D SUMMA with operand broadcasts at
the edges). One card holds every tile: the specs are scrubbed against the
current mesh as the reference's sharding constraints are, and the product
runs whole, quantized through the Tensorizer's W8A8 path (``tz.qdot``: the
qgemm kernel on the card) or in float.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.accounting import COLLECTIVES_NOTE, Accounting
from repro_torch.core import tensorizer as tz
from repro_torch.distributed import sharding as shd


def distributed_gemm(a: torch.Tensor, b: torch.Tensor, *, quantized: bool = True) -> torch.Tensor:
    """C = A @ B with A (M, K) rows over data, B (K, N) columns over model,
    C 2D-sharded: ``tz.qdot(a, b)`` (per-tensor A, per-channel B, int32
    accumulation) or ``a @ b``."""
    a = shd.with_sharding(a, ("data", None))
    b = shd.with_sharding(b, (None, "model"))
    out = tz.qdot(a, b) if quantized else a @ b
    return shd.with_sharding(out, ("data", "model"))


def dryrun_distributed_gemm(M: int = 32768, K: int = 32768, N: int = 32768,
                            quantized: bool = True) -> Dict:
    """The GEMM counted on meta f32 operands under the accounting context
    (nothing allocated): contraction FLOPs and reckoned bytes on the current
    mesh's one device, and the ideal 2MNK over its devices. Collective bytes
    are null: one device runs no collective. A pod mesh is refused: one
    card does not run its partitioned program."""
    mesh = shd.current_mesh()
    if mesh.size != 1:
        raise ValueError(f"mesh {mesh.axis_names} {mesh.axis_sizes}: the port counts "
                         f"the GEMM on one device")
    a = torch.empty((M, K), dtype=torch.float32, device="meta")
    b = torch.empty((K, N), dtype=torch.float32, device="meta")
    with Accounting() as acc:
        distributed_gemm(a, b, quantized=quantized)
    return {
        "flops_dev": acc.flops,
        "bytes_dev": acc.bytes_accessed,
        "collective_bytes_dev": None,
        "collectives": COLLECTIVES_NOTE,
        "ideal_flops_dev": 2.0 * M * K * N / mesh.size,
        "n_devices": mesh.size,
    }
