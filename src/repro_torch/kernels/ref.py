"""The oracles of ``repro/kernels/ref.py`` under their names, bound to the
port's plain versions (the correctness contracts of its kernels).

Where the order of the arithmetic differs from the JAX oracle:

- ``qgemm_ref`` (``qgemm_plain`` without ``sa``): the exact int32 product,
  then ``float(acc) * sb[n]``: the oracle's order.
- ``qgemm_tile_scales_ref`` (``qgemm_tile_scales_plain``): the port adds
  ``float(P_k) * (sa_k * sb_k)`` over k tiles, in k order, rounding the scale
  product first; the JAX oracle rounds ``(P_k * sa_k) * sb_k`` left to right
  and sums the k tiles with ``.sum(axis=1)``. The tile is fixed at 128 (the
  oracle's ``t`` default).
- ``stencil3x3_ref`` (``stencil3x3_plain``): the nine multiply-adds from
  zero in (p, q) order, as the oracle.
- ``qgemv_ref`` (``qgemv_plain``): ``(x @ float(w_q)) * scale``, as the
  oracle; the matmul's additions run in the order of PyTorch's f32 matmul.
"""

from __future__ import annotations

from repro_torch.kernels.qdot_serve import qgemv_plain as qgemv_ref
from repro_torch.kernels.qgemm import qgemm_plain as qgemm_ref
from repro_torch.kernels.qgemm import qgemm_tile_scales_plain as qgemm_tile_scales_ref
from repro_torch.kernels.stencil3x3 import stencil3x3_plain as stencil3x3_ref

__all__ = ["qgemm_ref", "qgemm_tile_scales_ref", "stencil3x3_ref", "qgemv_ref"]
