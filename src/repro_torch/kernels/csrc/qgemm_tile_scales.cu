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
// f32 output's bytes, narrowly).
//
// Design: the int8 tensor-core core of qgemm.cu (int8_mma.cuh: a 4-stage
// cp.async ring of 32-deep k stages, B in its public (K, N) layout and
// transposed 4x4 bytes at a time in registers, mma.sync.m16n8k32 s8). A
// block owns a 64x128 output sub-tile (8 warps of 32x32) or, where those
// give fewer than 2 blocks per SM (1024^3: 128 of them), a 64x64 one (4
// warps); either lies inside one 128x128 scale tile and shares its scale.
// The exact int32 partial of each 128-deep k tile (4 stages) sits in
// registers and is folded into the f32 accumulators once per k tile, in k
// order. K is not split across blocks: that would reorder the float adds.
// Not yet: wgmma, TMA, a persistent schedule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace i8mma;

constexpr int T = 128;  // tile edge: the scales' granularity
constexpr int STAGES = 4;

template <int WN>
__global__ void __launch_bounds__(32 * 2 * WN)
qgemm_tile_scales_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                         const float* __restrict__ sa, const float* __restrict__ sb,
                         float* __restrict__ out, int M, int N, int K) {
  constexpr int MT = 2, WM = 2;  // 64 rows: 2 warps of 2 m-tiles
  constexpr int THREADS = 32 * WM * WN;
  constexpr int BM = 16 * MT * WM, BN = 32 * WN;
  constexpr int A_BYTES = BM * KS, STAGE = A_BYTES + KS * BN;
  __shared__ __align__(128) int8_t smem[STAGES * STAGE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int bi = m0 / T, bj = n0 / T;
  const int Kb = K / T, Nb = N / T;
  const int nst = K / KS;

  int p[MT][4][4];
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[i][j][c] = 0;
        acc[i][j][c] = 0.0f;
      }

  auto load = [&](int s) {
    int8_t* st = smem + (s % STAGES) * STAGE;
    load_a_stage<BM, THREADS, true>(st, A, M, K, m0, KS * s, tid);
    load_b_stage<BN, THREADS, true>(st + A_BYTES, B, K, N, KS * s, n0, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_async_commit();
    const int8_t* st = smem + (s % STAGES) * STAGE;
    uint32_t b[4][2];
    load_b_frags<BN>(st + A_BYTES, 32 * wn, lane, b);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      load_a_frag(st, 16 * (MT * wm + i), lane, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(p[i][j], a, b[j]);
    }
    if ((s + 1) % (T / KS) == 0) {  // the k tile is complete: fold it in
      const int kb = s / (T / KS);
      const float sc = __fmul_rn(sa[bi * Kb + kb], sb[kb * Nb + bj]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][j][c] = __fadd_rn(acc[i][j][c], __fmul_rn(__int2float_rn(p[i][j][c]), sc));
            p[i][j][c] = 0;
          }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + 32 * wn + 8 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * (MT * wm + i) + g + 8 * h;
      float v[8];
      row_values(acc[i], h, v);
      float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
}

}  // namespace

// a (M, K) int8, b (K, N) int8, both 16-byte aligned; sa (M/128, K/128) f32,
// sb (K/128, N/128) f32, out (M, N) f32; M, N, K multiples of 128 (the
// wrapper checks). narrow = 1 takes the 64x64 sub-tiles, 0 the 64x128 ones.
extern "C" int qgemm_tile_scales_launch(const void* a, const void* b, const void* sa,
                                        const void* sb, void* out, int M, int N, int K,
                                        int narrow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* Bp = static_cast<const int8_t*>(b);
  const auto* SA = static_cast<const float*>(sa);
  const auto* SB = static_cast<const float*>(sb);
  auto* O = static_cast<float*>(out);
  if (narrow)
    qgemm_tile_scales_kernel<2><<<dim3(N / 64, M / 64), 128, 0, s>>>(A, Bp, SA, SB, O, M, N, K);
  else
    qgemm_tile_scales_kernel<4><<<dim3(N / 128, M / 64), 256, 0, s>>>(A, Bp, SA, SB, O, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
