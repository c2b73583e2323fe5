// Zero-padded 3x3 cross-correlation of an (H, W) f32 field, stride 1: the
// HotSpot3D stencil and the GPTPU conv2D instruction at 3x3.
//
// Replaces: src/repro/kernels/stencil3x3.py::stencil3x3 (_stencil_kernel),
// the Pallas row-blocked kernel.
//
//   out[r, c] = sum_p sum_q w[p, q] * x[r + p - 1, c + q - 1]
//
// with x = 0 outside the field, summed from 0 in (p, q) order; each term is
// rounded after the multiply and after the add (_rn intrinsics, no FMA), so
// the kernel is bitwise equal to the plain version (kernels/stencil3x3.py).
//
// Bound on this card: 18 operations per 8 bytes (one f32 read, one write),
// far below the f32 rate's balance point, so it is bound by bytes.
//
// Design: one block of 32 x 8 threads per 32 x 32 output tile. The block
// stages its 34 x 34 halo tile of x in shared memory, writing zeros for the
// cells outside the field, so the padded copy and the three row-shifted views
// the Pallas wrapper materializes (four extra passes over the field) do not
// exist. Each thread computes 4 rows of one column; the 9 weights sit in
// registers. Any H, W >= 1: the ragged edge tiles are masked.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;             // tile width (threadIdx.x)
constexpr int TH = 32;             // tile height
constexpr int TY = 8;              // threadIdx.y; each thread does TH / TY rows

__global__ void __launch_bounds__(TW * TY)
stencil3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W) {
  __shared__ float tile[TH + 2][TW + 3];   // +1 column of padding
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < (TH + 2) * (TW + 2); i += TW * TY) {
    const int r = i / (TW + 2), c = i % (TW + 2);
    const int gr = r0 + r - 1, gc = c0 + c - 1;
    tile[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                     ? x[static_cast<size_t>(gr) * W + gc] : 0.0f;
  }
  float wr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wr[i] = __ldg(w + i);
  __syncthreads();

  const int c = threadIdx.x, gc = c0 + c;
  if (gc >= W) return;
#pragma unroll
  for (int k = 0; k < TH / TY; ++k) {
    const int r = threadIdx.y + TY * k, gr = r0 + r;
    if (gr >= H) break;
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        acc = __fadd_rn(acc, __fmul_rn(wr[3 * p + q], tile[r + p][c + q]));
    out[static_cast<size_t>(gr) * W + gc] = acc;
  }
}

}  // namespace

// x (H, W) f32, w (3, 3) f32, out (H, W) f32, all contiguous on the device.
extern "C" int stencil3x3_launch(const void* x, const void* w, void* out, int H,
                                 int W, void* stream) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  dim3 block(TW, TY);
  stencil3x3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
