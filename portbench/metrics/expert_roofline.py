"""MoE experts (models/moe.py expert_outputs): the least time of the
window's routed-expert work (portbench/work.py ``Work.expert_least_s``: per
MoE layer and step, the larger of the experts' operations at the bf16 peak
and the bytes of the int8 codes and f32 scales of the experts uniform
routing touches, with the rows in and out), as a share of the device time
of every operation on the routed experts' path in the traced window: the
experts' dequantization on every forward (``moe._dequant``: int8 codes
times f32 scales, stored in bf16) and the batched expert products
(``torch.bmm`` in bf16, which cuBLAS runs as its ``nvjet_`` kernels on an
H100), picked by kernel name (KERNELS), and any kernel whose name holds
``moe_expert``, the name a hand-written expert kernel takes, so that the
share reads the same work whatever runs it.

The names were read from this cell's step on an H100 (torch 2.11, CUDA
12.8), each kernel grouped by the program range that launched it: the
dequantization kernel ran under ``moe._dequant`` alone (36 of 36
launches), and the ``nvjet_`` kernels under ``moe.expert_outputs`` (72 of
73; the other, 2% of their time, was linked to the shared experts' MLP,
whose projections run through qgemm and issue no float GEMM). Nothing
else in the step runs a bf16 GEMM: attention runs the paged-attention
kernel, the projections qgemm, the router an f32 GEMM with TF32 off."""

KERNELS = (
    "elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::BinaryFunctor"
    "<float, float, float, at::native::binary_internal::MulFunctor<float> > >",
    "nvjet_",
    "moe_expert",
)


def read(rec):
    if rec.trace is None:
        return None
    t = rec.trace.device_s(lambda name: any(k in name for k in KERNELS))
    return 100.0 * rec.work.expert_least_s / t if t > 0 and rec.work.expert_least_s else None
