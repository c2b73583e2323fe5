// Int8 GEMM with one scale per 128x128 tile of each operand: the blocked
// W8A8 product of the GPTPU FullyConnected lowering (tpuGemm).
//
// Replaces: src/repro/kernels/qgemm.py::qgemm_tile_scales
// (_qgemm_tile_scales_kernel), the Pallas MXU kernel.
//
//   out[i-tile, j-tile] = sum over k tiles, in k order, of
//                         float(P_ikj) * (sa[i, k] * sb[k, j])
//
// where P_ikj is the exact int32 product of one 128-deep tile pair. |P| <=
// 128 * 128^2 < 2^24, so float(P) is exact. Each step rounds the scale
// product, then the multiply, then the add (qgemm.py:109's order); the
// _rn intrinsics keep nvcc from contracting them into an FMA, so the kernel
// is bitwise equal to a plain loop over k in the same order.
//
// Bound on this card: 2*M*N*K int8 operations against M*K + K*N bytes in and
// 4*M*N out. At 4096^3 the int8 tensor-core rate bounds it (at 1024^3 the
// f32 output's bytes, narrowly); dp4a on the CUDA cores reaches neither.
//
// Design (simple first): one block of 256 threads per 128x128 output tile;
// each thread owns an 8x8 sub-grid of outputs (rows ty + 16*i, columns
// tx + 16*j). For each k tile the A tile is staged row-major and the B tile
// transposed in shared memory, so every 32-bit shared word holds 4
// consecutive k values of one row or one column: dp4a's operand layout, as
// in qgemm.cu. B keeps its public (K, N) layout; the transpose of each 4x4
// byte block happens in registers. The int32 partials of the tile pair stay
// in registers and are folded into the f32 accumulators once per k tile.
// Not yet: tensor cores (mma.sync / wgmma s8), TMA, a pipelined k loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;             // tile edge: the scales' granularity
constexpr int THREADS = 256;       // 16 x 16
constexpr int STRIDE = T + 4;      // bytes per shared row: 33 words, odd, so
                                   // 16 rows at one k hit 16 banks

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int i) {
  return (w >> (8 * i)) & 0xffu;
}

__global__ void __launch_bounds__(THREADS)
qgemm_tile_scales_kernel(const int8_t* __restrict__ A,
                         const int8_t* __restrict__ B,
                         const float* __restrict__ sa,
                         const float* __restrict__ sb,
                         float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[T][STRIDE];   // [m][k]
  __shared__ __align__(16) int8_t Bs[T][STRIDE];   // [n][k]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int m0 = bi * T, n0 = bj * T;
  const int Kb = K / T, Nb = N / T;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < Kb; ++kb) {
    const int k0 = kb * T;
    // A tile: 128 rows x 32 words, read along k (coalesced), stored as is.
    for (int c = tid; c < T * (T / 4); c += THREADS) {
      const int r = c / (T / 4), kw = c % (T / 4);
      *reinterpret_cast<uint32_t*>(&As[r][4 * kw]) =
          *reinterpret_cast<const uint32_t*>(A + static_cast<size_t>(m0 + r) * K +
                                             k0 + 4 * kw);
    }
    // B tile: 32 groups of 4 k rows x 32 groups of 4 columns; each thread
    // reads a 4x4 byte block (4 words along n) and writes it transposed
    // (4 words along k).
    for (int c = tid; c < (T / 4) * (T / 4); c += THREADS) {
      const int kg = c / (T / 4), ng = c % (T / 4);
      const int8_t* src = B + static_cast<size_t>(k0 + 4 * kg) * N + n0 + 4 * ng;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(i) * N);
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const uint32_t w = byte_of(r[0], col) | (byte_of(r[1], col) << 8) |
                           (byte_of(r[2], col) << 16) | (byte_of(r[3], col) << 24);
        *reinterpret_cast<uint32_t*>(&Bs[4 * ng + col][4 * kg]) = w;
      }
    }
    __syncthreads();

    int p[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[i][j] = 0;
#pragma unroll 4
    for (int kk = 0; kk < T; kk += 4) {
      int a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = __dp4a(a[i], b[j], p[i][j]);
    }
    __syncthreads();

    const float s = __fmul_rn(sa[bi * Kb + kb], sb[kb * Nb + bj]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(p[i][j]), s));
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[static_cast<size_t>(m0 + ty + 16 * i) * N + n0 + tx + 16 * j] = acc[i][j];
}

}  // namespace

// a (M, K) int8, b (K, N) int8, sa (M/128, K/128) f32, sb (K/128, N/128)
// f32, out (M, N) f32; M, N, K multiples of 128 (the wrapper checks).
extern "C" int qgemm_tile_scales_launch(const void* a, const void* b,
                                        const void* sa, const void* sb,
                                        void* out, int M, int N, int K,
                                        void* stream) {
  dim3 grid(N / T, M / T);
  qgemm_tile_scales_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
