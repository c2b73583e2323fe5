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
// rate, so it is bound by the bytes of B (3.35 TB/s). A large-M product
// (prefill, tpuGemm's conv2D lowering at 4096^3) is bound by operations.
//
// Design: one kernel, two regimes, both on the int8 tensor cores
// (mma.sync.m16n8k32 s8, operands staged by int8_mma.cuh: a cp.async ring
// of 32-deep k stages, B in its public (K, N) layout, transposed 4x4 bytes
// at a time in registers). The wrapper's plan (kernels/qgemm.py) picks the
// tile and the split of K:
// - M <= 16 (decode, pagerank's mat-vec): A's rows padded to one 16-row
//   m-tile, so every weight byte is read from device memory once and used
//   for all M rows. The tensor cores, not dp4a: a dp4a version of this tile
//   (the same transposed B words are dp4a's operands) was bitwise equal and
//   slower at every decode projection shape at M = 1, 8 and 16 on the H100;
//   its arithmetic at 16 padded rows rivals the weight's byte time. 4 warps
//   per block over a 128-, 64- or 32-column stripe, the narrower the fewer
//   columns N has; warps not needed across the stripe take consecutive k
//   stages and add their sums in shared memory at the end. 8 to 16 stages
//   (4 KB of B each at 128 columns) in the ring.
// - M > 16: 128x128 tiles of 8 warps (each 64x32), 128x64 tiles of 4 warps
//   (64x32) or 64x64 tiles of 4 warps (32x32); 4 stages.
// - K is split across blocks until the grid holds about 2 blocks per SM.
//   int32 sums associate exactly, so a split costs no bits: each split
//   stores its int32 sums to a scratch plane of its own (coalesced, 32 bytes
//   a lane), and a second small kernel adds the planes and runs the
//   epilogue. Unsplit, the epilogue runs from registers. Not int32 atomics
//   into one zeroed plane: a warp's 32 atomics touch 32 sectors, and on the
//   H100 that made the M = 128 splits slower than torch._int_mm.
// - Ragged M, N and K: copies past an edge are zero-filled. Where K or N is
//   not a multiple of 16, or an operand is not 16-byte aligned, the same
//   kernel stages its tiles with bounds-checked byte loads instead of
//   cp.async.
// Not yet: wgmma, TMA, a persistent schedule, a B tile shared by a cluster,
// the splits' sums added by the last split to arrive instead of a second
// kernel (at decode the second kernel takes about as long as the first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace i8mma;

// Writes the W (4 or 8) outputs of row `row`, columns col .. col + W - 1,
// from their int32 sums.
template <int W>
__device__ __forceinline__ void store_out(void* out, int out_bf16, const float* sa,
                                          const float* sb, int row, int col, const int (&v)[W],
                                          int M, int N) {
  if (row >= M) return;
  const float ra = sa != nullptr ? sa[row] : 0.0f;
  float f[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const int n = col + c < N ? col + c : N - 1;
    const float s = sa != nullptr ? __fmul_rn(ra, sb[n]) : sb[n];
    f[c] = __fmul_rn(__int2float_rn(v[c]), s);
  }
  const size_t o = static_cast<size_t>(row) * N + col;
  if (col + W <= N && N % W == 0) {
    if (out_bf16) {
      uint32_t w[W / 2];
#pragma unroll
      for (int c = 0; c < W / 2; ++c) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * c], f[2 * c + 1]);
        w[c] = *reinterpret_cast<const uint32_t*>(&h);
      }
      auto* p = reinterpret_cast<__nv_bfloat16*>(out) + o;
      if constexpr (W == 8)
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      float4* p = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
#pragma unroll
      for (int q = 0; q < W / 4; ++q)
        p[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (col + c >= N) break;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[o + c] = __float2bfloat16_rn(f[c]);
    else
      reinterpret_cast<float*>(out)[o + c] = f[c];
  }
}

// MT m-tiles of 16 rows per warp, WM x WN warps over the output tile, WK
// warps over consecutive k stages of it: the ring advances a group of WK
// stages at a time, warp wk computing stage wk of each group.
template <int MT, int WM, int WN, int WK, int STAGES, bool VEC>
__global__ void __launch_bounds__(32 * WM * WN * WK)
qgemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
             const float* __restrict__ sb, const float* __restrict__ sa,
             void* __restrict__ out, int* __restrict__ partial, int M, int N, int K,
             int kchunk, int out_bf16) {
  constexpr int THREADS = 32 * WM * WN * WK;
  constexpr int BM = 16 * MT * WM, BN = 32 * WN;
  constexpr int A_BYTES = BM * KS, STAGE = A_BYTES + KS * BN;
  constexpr int GROUPS = STAGES / WK;  // ring slots, in groups
  static_assert(STAGES % WK == 0 && GROUPS >= 2, "the ring holds whole groups");
  constexpr int RED_BYTES = (WK - 1) * WM * WN * 32 * 16 * MT * 4;
  constexpr int SMEM = STAGES * STAGE > RED_BYTES ? STAGES * STAGE : RED_BYTES;
  __shared__ __align__(128) int8_t smem[SMEM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / (WM * WN), wmn = warp % (WM * WN);
  const int wm = wmn / WN, wn = wmn % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int nst = (k_end - k_begin + KS - 1) / KS;
  const int ngr = (nst + WK - 1) / WK;

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  auto load_group = [&](int gi) {
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const int s = gi * WK + w;
      if (s >= nst) break;
      int8_t* st = smem + (s % STAGES) * STAGE;
      const int k0 = k_begin + KS * s;
      load_a_stage<BM, THREADS, VEC>(st, A, M, K, m0, k0, tid);
      load_b_stage<BN, THREADS, VEC>(st + A_BYTES, B, K, N, k0, n0, tid);
    }
  };

#pragma unroll
  for (int gi = 0; gi < GROUPS - 1; ++gi) {
    if (gi < ngr) load_group(gi);
    cp_async_commit();
  }
  for (int gi = 0; gi < ngr; ++gi) {
    cp_async_wait<GROUPS - 2>();
    __syncthreads();  // group gi has landed; every warp is done with group gi - 1
    if (gi + GROUPS - 1 < ngr) load_group(gi + GROUPS - 1);
    cp_async_commit();
    const int s = gi * WK + wk;
    if (s < nst) {
      const int8_t* st = smem + (s % STAGES) * STAGE;
      uint32_t b[4][2];
      load_b_frags<BN>(st + A_BYTES, 32 * wn, lane, b);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        load_a_frag(st, 16 * (MT * wm + i), lane, a);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b[j]);
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (WK > 1) {  // add the other k warps' sums into warps wk == 0
    __syncthreads();       // the stages are free
    int* red = reinterpret_cast<int*>(smem);
    constexpr int R = 16 * MT;
    if (wk > 0) {
      int* mine = red + ((wk - 1) * WM * WN + wmn) * R * 32;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) mine[(16 * i + 4 * j + c) * 32 + lane] = acc[i][j][c];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int w = 0; w < WK - 1; ++w) {
        const int* other = red + (w * WM * WN + wmn) * R * 32;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] += other[(16 * i + 4 * j + c) * 32 + lane];
      }
    }
  }

  if (wk != 0) return;
  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + 32 * wn + 8 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * (MT * wm + i) + g + 8 * h;
      int v[8];
      row_values(acc[i], h, v);
      if (gridDim.z == 1) {
        store_out<8>(out, out_bf16, sa, sb, row, col, v, M, N);
      } else if (row < M) {  // this split's sums, for qgemm_combine
        int* dst = partial + (static_cast<size_t>(blockIdx.z) * M + row) * N + col;
        if (col + 8 <= N && N % 8 == 0) {
          reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (col + c < N) dst[c] = v[c];
        }
      }
    }
}

// out = epilogue(sum over splits of partial[split]): 4 columns of one row
// per thread, the splits' loads unrolled so that several are in flight. The
// int32 sums are exact in any order.
__global__ void __launch_bounds__(256)
qgemm_combine(const int* __restrict__ partial, const float* __restrict__ sb,
              const float* __restrict__ sa, void* __restrict__ out, int M, int N,
              int splits, int out_bf16) {
  const int groups = (N + 3) / 4;
  const size_t plane = static_cast<size_t>(M) * N;
  for (size_t q = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       q < static_cast<size_t>(M) * groups; q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(q / groups), col = 4 * static_cast<int>(q % groups);
    const int* src = partial + static_cast<size_t>(row) * N + col;
    int v[4] = {0, 0, 0, 0};
    if (col + 4 <= N && N % 4 == 0) {
#pragma unroll 8
      for (int p = 0; p < splits; ++p) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(src + p * plane));
        v[0] += x.x; v[1] += x.y; v[2] += x.z; v[3] += x.w;
      }
    } else {
      for (int p = 0; p < splits; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < N) v[c] += src[p * plane + c];
    }
    store_out<4>(out, out_bf16, sa, sb, row, col, v, M, N);
  }
}

template <int MT, int WM, int WN, int WK, int STAGES>
cudaError_t launch(bool vec, const int8_t* A, const int8_t* B, const float* sb,
                   const float* sa, void* out, int* partial, int M, int N, int K,
                   int kchunk, int splits, int out_bf16, cudaStream_t s) {
  constexpr int BM = 16 * MT * WM, BN = 32 * WN;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int threads = 32 * WM * WN * WK;
  if (vec)
    qgemm_kernel<MT, WM, WN, WK, STAGES, true><<<grid, threads, 0, s>>>(
        A, B, sb, sa, out, partial, M, N, K, kchunk, out_bf16);
  else
    qgemm_kernel<MT, WM, WN, WK, STAGES, false><<<grid, threads, 0, s>>>(
        A, B, sb, sa, out, partial, M, N, K, kchunk, out_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t items = static_cast<size_t>(M) * ((N + 3) / 4);
  const int blocks = static_cast<int>(items / 256 + 1 < 4096 ? items / 256 + 1 : 4096);
  qgemm_combine<<<blocks, 256, 0, s>>>(partial, sb, sa, out, M, N, splits, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// a (M, K) int8, b (K, N) int8, sb (N,) f32, sa (M,) f32 or null, out (M, N)
// f32 or bf16. `config` is the plan's tile (kernels/qgemm.py: 0-2 the
// 16-row decode tiles 128, 64 and 32 columns wide, 3-5 the 128x128, 128x64
// and 64x64 tiles); K is split into `splits` ranges of `kchunk` (a multiple
// of 32). With splits > 1, `partial` holds splits x M x N int32.
extern "C" int qgemm_launch(const void* a, const void* b, const void* sb, const void* sa,
                            void* out, void* partial, int M, int N, int K, int out_bf16,
                            int config, int kchunk, int splits, void* stream) {
  const bool vec = K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* Bp = static_cast<const int8_t*>(b);
  const auto* SB = static_cast<const float*>(sb);
  const auto* SA = static_cast<const float*>(sa);
  int* P = static_cast<int*>(partial);
  cudaError_t err;
  switch (config) {
    case 0: err = launch<1, 1, 4, 1, 8>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    case 1: err = launch<1, 1, 2, 2, 16>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    case 2: err = launch<1, 1, 1, 4, 16>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    case 3: err = launch<4, 2, 4, 1, 4>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    case 4: err = launch<4, 2, 2, 1, 4>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    case 5: err = launch<2, 2, 2, 1, 4>(vec, A, Bp, SB, SA, out, P, M, N, K, kchunk, splits, out_bf16, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
