// W8A8 int8 GEMM with exact int32 accumulation and a fused dequant epilogue.
//
// Replaces: src/repro/kernels/qgemm.py::qgemm (_qgemm_kernel), the Pallas
// MXU kernel, and in the port also the XLA int8 dot_general that
// models/layers.py::pdot runs for every W8A8 projection.
//
//   out[m, n] = cast(float(sum_k a[m, k] * b[k, n]) * (sa[m] * sb[n]))
//
// with sa omitted (treated as 1 and not multiplied) when it is null. The
// scale product comes first, then the multiply, then the cast to the output
// type (f32 or bf16, round to nearest even): pdot's order.
//
// Bound on this card: a decode projection (M <= slots) reads the whole int8
// weight once and does 2*M*K*N operations, far below the 1,979 TOP/s int8
// rate, so it is bound by the bytes of B (3.35 TB/s). A prefill projection
// (M = slots x bucket) is bound by operations.
//
// Design (simple first): a 64-column x (16 or 64)-row output tile per block
// of 256 threads; K advances 32 at a time through shared memory. The A tile
// is stored row-major and the B tile transposed, so each 32-bit shared word
// holds 4 consecutive k values of one row or one column: exactly the operand
// layout of __dp4a, which accumulates 4 int8 products into int32 exactly. The
// transpose happens in shared memory, so B keeps its public (K, N) layout and
// no repacked copy of the weights exists. Ragged M, N and K edges load as
// zeros, which add nothing to the sums. Decode shapes (M <= 16) take the
// 16-row tile so 3/4 of the block is not spent on rows that do not exist.
// Not yet: tensor cores (mma.sync / wgmma s8), TMA, split-K for narrow N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int BS_STRIDE = BK + 4;  // bytes per transposed B row; 9 words,
                                   // odd, so 16 columns hit 16 banks

__device__ __forceinline__ int32_t load4(const int8_t* p, int valid, bool vec) {
  // 4 consecutive int8 values as one little-endian word, zero past `valid`.
  if (vec && valid >= 4) return *reinterpret_cast<const int32_t*>(p);
  uint32_t u = 0;
  for (int i = 0; i < 4 && i < valid; ++i)
    u |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
  return static_cast<int32_t>(u);
}

template <int TM>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
             const float* __restrict__ sb, const float* __restrict__ sa,
             void* __restrict__ out, int M, int N, int K, int out_bf16,
             int vec_a, int vec_b) {
  constexpr int BM = 16 * TM;
  __shared__ __align__(16) int8_t As[BM][BK];
  __shared__ __align__(16) int8_t Bs[BN][BS_STRIDE];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM rows x BK bytes, one 4-byte chunk per step.
    for (int c = tid; c < BM * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + kc;
      int32_t v = 0;
      if (gm < M && gk < K)
        v = load4(A + static_cast<size_t>(gm) * K + gk, K - gk, vec_a);
      *reinterpret_cast<int32_t*>(&As[r][kc]) = v;
    }
    // B tile: BK rows x BN bytes, read along n, stored transposed.
    for (int c = tid; c < BK * (BN / 4); c += THREADS) {
      const int kr = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const int gk = k0 + kr, gn = n0 + nc;
      int32_t v = 0;
      if (gk < K && gn < N)
        v = load4(B + static_cast<size_t>(gk) * N + gn, N - gn, vec_b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Bs[nc + i][kr] = static_cast<int8_t>((v >> (8 * i)) & 0xff);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty * TM + i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float s = sa != nullptr ? __fmul_rn(sa[gm], sb[gn]) : sb[gn];
      const float v = __fmul_rn(__int2float_rn(acc[i][j]), s);
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int qgemm_launch(const void* a, const void* b, const void* sb,
                            const void* sa, void* out, int M, int N, int K,
                            int out_bf16, void* stream) {
  const int vec_a = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  const int vec_b = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(b) % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* Bp = static_cast<const int8_t*>(b);
  const auto* SB = static_cast<const float*>(sb);
  const auto* SA = static_cast<const float*>(sa);
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    qgemm_kernel<1><<<grid, THREADS, 0, s>>>(A, Bp, SB, SA, out, M, N, K,
                                             out_bf16, vec_a, vec_b);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    qgemm_kernel<4><<<grid, THREADS, 0, s>>>(A, Bp, SB, SA, out, M, N, K,
                                             out_bf16, vec_a, vec_b);
  }
  return static_cast<int>(cudaGetLastError());
}
