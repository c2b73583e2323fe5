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
// Design: streamed column strips, no shared-memory tile.
// - A warp owns a band of 32 * V columns (lane l: columns l * V .. l * V +
//   V - 1 of the band) and walks down a strip of `rows` output rows; the
//   warps of a block take adjacent bands of one strip. V = 4 when W % 4 ==
//   0 and x is 16-byte aligned (the wrapper's plan), so each input row is
//   one 16-byte load per lane and each output row one 16-byte streaming
//   store (__stcs: the output does not evict the input from L2); else V =
//   1, the same kernel with 4-byte accesses.
// - The warp keeps a 3-row window in registers. A row's left and right
//   neighbour columns come from the adjacent lanes by __shfl_up_sync /
//   __shfl_down_sync; across the warps of a block, lane 31's and lane 0's
//   values are exchanged through 64 bytes of shared memory (one block
//   barrier per input row). Only the block's two outer lanes load one more
//   column each, and none where the block spans the field's width. Rows
//   above and below the field and columns beside it are zeros.
// - DEPTH raw rows are in flight per lane: the slot a row is consumed from
//   is refilled with the row DEPTH further down at once, so loads keep
//   streaming while the warp computes.
// - Each strip reads its two halo rows again (2 / rows of the input, mostly
//   from L2). The plan (kernels/stencil3x3.py::plan) picks the width and the
//   strip height from the shape, the alignment and the SM count.
// - WARPS = 4 and DEPTH = 2 were the fastest at both 1024^2 and 4096^2 of a
//   sweep (kernel_sweep.py --sweep, which builds other values by defining
//   STENCIL_WARPS and STENCIL_DEPTH).
// Any H, W >= 1: lanes past W load zeros and store nothing.

#include <cuda_runtime.h>

namespace {

#ifndef STENCIL_WARPS
#define STENCIL_WARPS 4
#endif
#ifndef STENCIL_DEPTH
#define STENCIL_DEPTH 2
#endif
constexpr int WARPS = STENCIL_WARPS;   // warps per block, in adjacent bands
constexpr int DEPTH = STENCIL_DEPTH;   // input rows in flight per lane past the window's two

template <int V>
struct Raw {                       // one input row as this lane loaded it
  float v[V];
  float edge;                      // the block's outer lanes: the column beside the block
};

template <int V>
struct Row {                       // the row with both neighbour columns
  float f[V + 2];                  // columns c0 - 1 .. c0 + V
};

// Row r of this lane's columns c0 .. c0 + V - 1 (a whole 16-byte chunk for
// V = 4, inside the field or outside it) and, for the block's outer lanes,
// column `outer`; zeros outside the field and outside the rows lo .. hi
// that the strip reads.
template <int V>
__device__ __forceinline__ void load_row(Raw<V>& raw, const float* __restrict__ x, int r,
                                         int lo, int hi, int H, int W, int c0, int outer) {
#pragma unroll
  for (int j = 0; j < V; ++j) raw.v[j] = 0.0f;
  raw.edge = 0.0f;
  if (r < lo || r > hi || r < 0 || r >= H) return;
  const float* row = x + static_cast<size_t>(r) * W;
  if (c0 < W) {
    if constexpr (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + c0));
      raw.v[0] = t.x; raw.v[1] = t.y; raw.v[2] = t.z; raw.v[3] = t.w;
    } else {
      raw.v[0] = __ldg(row + c0);
    }
  }
  if (outer >= 0 && outer < W) raw.edge = __ldg(row + outer);
}

// The row with its neighbour columns: from lanes l - 1 and l + 1, across
// warps through `edges` (this row's half of the double buffer), at the
// block's outer lanes from the column loaded beside the block. Every
// thread of the block calls it once per input row, in the same order.
template <int V>
__device__ __forceinline__ Row<V> complete(const Raw<V>& raw, float (*edges)[2], int lane,
                                           int warp) {
  Row<V> row;
  float l = __shfl_up_sync(0xffffffffu, raw.v[V - 1], 1);
  float r = __shfl_down_sync(0xffffffffu, raw.v[0], 1);
  if (lane == 0) edges[warp][0] = raw.v[0];
  if (lane == 31) edges[warp][1] = raw.v[V - 1];
  __syncthreads();
  if (lane == 0) l = warp > 0 ? edges[warp - 1][1] : raw.edge;
  if (lane == 31) r = warp < WARPS - 1 ? edges[warp + 1][0] : raw.edge;
  row.f[0] = l;
#pragma unroll
  for (int j = 0; j < V; ++j) row.f[j + 1] = raw.v[j];
  row.f[V + 1] = r;
  return row;
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
stencil3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int H, int W, int rows, int wide) {
  __shared__ float edges[2][WARPS][2];    // [row parity][warp][first, last value]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = blockIdx.x / wide, span = WARPS * 32 * V;
  const int r0 = strip * rows;
  if (r0 >= H) return;                                  // uniform over the block
  const int r1 = min(H, r0 + rows);                     // output rows r0 .. r1 - 1
  const int b0 = (blockIdx.x % wide) * span;            // the block's first column
  const int c0 = b0 + (32 * warp + lane) * V;
  const int outer = warp == 0 && lane == 0 ? b0 - 1
                    : warp == WARPS - 1 && lane == 31 ? b0 + span : -1;

  float wr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wr[i] = __ldg(w + i);

  // input rows r0 - 1 .. r1 are read; the rest of the window is zeros
  Raw<V> ra, rb, buf[DEPTH];
  load_row<V>(ra, x, r0 - 1, r0 - 1, r1, H, W, c0, outer);
  load_row<V>(rb, x, r0, r0 - 1, r1, H, W, c0, outer);
#pragma unroll
  for (int i = 0; i < DEPTH; ++i)
    load_row<V>(buf[i], x, r0 + 1 + i, r0 - 1, r1, H, W, c0, outer);
  Row<V> a = complete<V>(ra, edges[1], lane, warp);
  Row<V> b = complete<V>(rb, edges[0], lane, warp);

  for (int r = r0; r < r1; r += DEPTH) {
    // buf[i] holds input row r + 1 + i
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const Row<V> c = complete<V>(buf[i], edges[(i + 1) & 1], lane, warp);
      load_row<V>(buf[i], x, r + 1 + i + DEPTH, r0 - 1, r1, H, W, c0, outer);
      if (r + i < r1 && c0 < W) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < 3; ++q) acc = __fadd_rn(acc, __fmul_rn(wr[q], a.f[j + q]));
#pragma unroll
          for (int q = 0; q < 3; ++q) acc = __fadd_rn(acc, __fmul_rn(wr[3 + q], b.f[j + q]));
#pragma unroll
          for (int q = 0; q < 3; ++q) acc = __fadd_rn(acc, __fmul_rn(wr[6 + q], c.f[j + q]));
          o[j] = acc;
        }
        float* dst = out + static_cast<size_t>(r + i) * W + c0;
        if constexpr (V == 4)
          __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
        else
          __stcs(dst, o[0]);
      }
      a = b;
      b = c;
    }
  }
}

template <int V>
int launch(const float* x, const float* w, float* out, int H, int W, int rows, cudaStream_t s) {
  const int wide = (W + WARPS * 32 * V - 1) / (WARPS * 32 * V);
  const long long blocks = static_cast<long long>(wide) * ((H + rows - 1) / rows);
  stencil3x3_kernel<V><<<static_cast<int>(blocks), 32 * WARPS, 0, s>>>(x, w, out, H, W, rows,
                                                                       wide);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (H, W) f32, w (3, 3) f32, out (H, W) f32, all contiguous on the device.
// width 4 needs W % 4 == 0 and x 16-byte aligned (out is a fresh tensor);
// rows >= 1 output rows per warp.
extern "C" int stencil3x3_launch(const void* x, const void* w, void* out, int H, int W,
                                 int width, int rows, void* stream) {
  const auto* X = static_cast<const float*>(x);
  const auto* Wt = static_cast<const float*>(w);
  auto* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (width == 4 && W % 4 == 0) return launch<4>(X, Wt, O, H, W, rows, s);
  if (width == 1) return launch<1>(X, Wt, O, H, W, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
