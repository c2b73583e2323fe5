// The routed experts of a mixture-of-experts layer over int8 expert weights:
// a pair of kernels, the gated up-projection and the down-projection,
// launched one after the other for each MoE layer of a forward.
//
// Replaces no TPU kernel: the JAX package contracts the experts through XLA
// (src/repro/models/moe.py, batched dot_generals over dequantized weights).
// The port's former path dequantized every expert of the layer to bf16 on
// every forward and ran batched library products over (E, 32, D) buffers of
// padded rows.
//
//   moe_expert_swiglu: h[r] = silu(x[rows[r]] @ wi[e]) * (x[rows[r]] @ wg[e])
//   moe_expert_down:   out[pairs[r]] = h[r] @ wo[e]
//
// for every slot r of expert e's queue, offsets[e] <= r < offsets[e] +
// counts[e]: the (token, k) pairs sorted by expert, `rows` their tokens and
// `pairs` their places in pair order. A weight is (E, K, N) int8 codes,
// row-major, with f32 scales (E, N), one per output column.
//
// Numbers: a weight is q * scale in f32, rounded once to bf16 (the values of
// models/moe.py::_dequant); the products run in bf16 with f32 sums, each
// rounded to bf16; then silu as models/layers.py::silu writes it, op by op
// in bf16 (exp, 1 +, 1 /, x *), and its product with the gate, rounded.
//
// Bound on this card: bytes. The experts do 2 x rows bf16 operations per
// int8 code, with rows about 6 an expert at decode and about 96 for a
// 1024-token chunk of deepseek-moe-16b, far below the ~295 operations a
// byte at which the tensor cores would bind. The least time is one read of
// the touched experts' codes and scales: 553 MB a layer for D 2048, F 1408
// and 64 experts, 165 us at 3.35 TB/s.
//
// Design:
// - One block per (M slice, 128-column tile, expert), 4 warps of 32
//   columns over all the tile's rows; an expert with no rows exits at once.
//   Its rows are cut in M tiles of BM: at decode 16 (one m-tile), one slice,
//   so each code leaves device memory once; above, 64 (four m-tiles) and as many
//   slices as the longest queue possible needs tiles, slice s taking tiles
//   s, s + slices, ...: the slices of one expert and column tile run side
//   by side and read its codes from device memory once, the later ones
//   from L2. Each expert's count and offset are read on the device: nothing
//   is read back to the host, and the grid depends on the slices, E and N
//   alone. (Tile shapes from a sweep on an H100 at deepseek-moe-16b's
//   widths: 128 columns beat 64, which read each row of x twice as often;
//   at 1024 tokens 64-row tiles in slices beat 16 and 32, and one slice at
//   decode beats four.)
// - Codes and rows streamed by cp.async through a ring of RING stages of
//   BK = 64 k, 16 bytes a copy, zero past K; the rows of x are gathered
//   through `rows` in the copy (no repeated or padded copy of x exists).
// - Dequantized in registers as the operand is loaded: a lane reads 4 words
//   (k rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-deep step, columns 4g .. 4g +
//   3 of its warp's 32), widens each byte exactly to f32 (a byte permute and
//   a subtract), multiplies by its column's scale and packs two k into a
//   bf16 pair: the B fragments of 4 n-tiles, column 4g + j taken as column g
//   of n-tile j (a relabelling that moves nothing, as in int8_mma.cuh). A
//   code tile's 16-byte chunks are swizzled within 128-byte lines so the
//   four k rows a warp reads at once fall on all 32 banks; the rows of x are
//   swizzled for ldmatrix.
// - One reduction order per row: every configuration runs the same
//   mma.sync.m16n8k16 over k in ascending steps of 16 into one f32 sum per
//   output, K never split, so a row's bits depend neither on its batchmates
//   nor on BM: a prefill row equals the decode step at its position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using i8mma::cp_async16;
using i8mma::cp_async_commit;
using i8mma::cp_async_wait;
using i8mma::smem_addr;

constexpr int BN = 128;            // output columns per block
constexpr int WARPS = BN / 32;     // 32 columns a warp, every warp over all BM rows
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 64;             // k per ring stage
constexpr int RING = 4;            // ring stages, RING - 1 in flight
constexpr int A_ROW = 2 * BK;      // bytes of a staged row of x or h: 8 chunks
constexpr int B_TILE = BK * BN;    // bytes of a staged code tile

// Bytes of a ring stage: BM rows of x or h and NW code tiles.
template <int BM, int NW>
__host__ __device__ constexpr int stage_bytes() { return BM * A_ROW + NW * B_TILE; }

// Byte offset of 16-byte chunk c (0..7) of row r of a staged A tile: the
// chunk index XORed with r % 8, so the 8 rows of an ldmatrix phase fall on
// 8 different bank groups.
__device__ __forceinline__ int a_offset(int r, int c) { return r * A_ROW + ((c ^ (r & 7)) << 4); }

// Byte offset of 16-byte chunk c (0..7) of k row r of a staged code tile:
// one row a 128-byte line, its 8 chunk slots XORed with 2 * ((r / 2) % 4),
// which puts rows r, r + 2, r + 4, r + 6 (a warp's four t at once) on
// disjoint slot pairs.
__device__ __forceinline__ int b_offset(int r, int c) {
  return (r << 7) + ((c ^ (((r >> 1) & 3) << 1)) << 4);
}

// Stage k [k0, k0 + BK) of the M tile's rows of A (srow: the row of A of
// each tile row, -1 past the queue) and of the NW code tiles' columns
// [n0, n0 + BN).
template <int BM, int NW>
__device__ __forceinline__ void load_stage(uint8_t* st, const __nv_bfloat16* __restrict__ A,
                                           const int* srow, const int8_t* const (&W)[NW], int K,
                                           int N, int n0, int k0, int tid) {
#pragma unroll
  for (int q = tid; q < BM * 8; q += THREADS) {
    const int r = q >> 3, c = q & 7;
    const int row = srow[r], k = k0 + 8 * c;
    const bool ok = row >= 0 && k < K;
    cp_async16(st + a_offset(r, c), ok ? A + static_cast<size_t>(row) * K + k : A, ok);
  }
  uint8_t* bs = st + BM * A_ROW;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int q = tid; q < BK * 8; q += THREADS) {
      const int r = q >> 3, c = q & 7;
      const int k = k0 + r, n = n0 + 16 * c;
      const bool ok = k < K && n < N;
      cp_async16(bs + w * B_TILE + b_offset(r, c),
                 ok ? W[w] + static_cast<size_t>(k) * N + n : W[w], ok);
    }
  }
}

// The word of 4 codes at byte `byte` of chunk c of k row r of a staged code
// tile, XORed with 0x80808080 for dequant.
__device__ __forceinline__ uint32_t code_word(const uint8_t* tile, int r, int c, int byte) {
  return *reinterpret_cast<const uint32_t*>(tile + b_offset(r, c) + byte) ^ 0x80808080u;
}

// Byte j of code word u (already XORed with 0x80808080) times scale s, in
// f32: the byte + 128 under the exponent of 2^23 gives 2^23 + 128 + q, and
// the subtract leaves q exactly; the product rounds once.
__device__ __forceinline__ float dequant(uint32_t u, int j, float s) {
  const float q =
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)), 8388736.0f);
  return __fmul_rn(q, s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d += a (16 x 16, bf16) @ b (16 x 8, bf16), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's products over one staged k range: the tile's MT m-tiles of 16
// rows by the 32 columns [wc, wc + 32) of each of the NW code tiles.
template <int MT, int NW>
__device__ __forceinline__ void compute_stage(const uint8_t* st, int wc, int lane,
                                              const float (&scale)[NW][4],
                                              float (&acc)[NW][MT][4][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* bs = st + 16 * MT * A_ROW;
  const int c = (wc + 4 * g) >> 4, byte = (wc + 4 * g) & 15;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t p =
          smem_addr(st + a_offset(16 * mt + (lane & 15), (kk >> 3) + (lane >> 4)));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
                   : "r"(p));
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint8_t* tile = bs + w * B_TILE;
      const int k0 = kk + 2 * t;
      const uint32_t u0 = code_word(tile, k0, c, byte);
      const uint32_t u1 = code_word(tile, k0 + 1, c, byte);
      const uint32_t u8 = code_word(tile, k0 + 8, c, byte);
      const uint32_t u9 = code_word(tile, k0 + 9, c, byte);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = scale[w][j];
        const uint32_t b0 = pack_bf16(dequant(u0, j, s), dequant(u1, j, s));
        const uint32_t b1 = pack_bf16(dequant(u8, j, s), dequant(u9, j, s));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[w][mt][j], a[mt], b0, b1);
      }
    }
  }
}

// silu(a) * b as the former path rounds it: a and b the products rounded to
// bf16, then exp(-a), 1 + e, 1 / d and a * r each rounded to bf16, and the
// product with b rounded on the store.
__device__ __forceinline__ float swiglu(float ai, float ag) {
  const float a = round_bf16(ai), b = round_bf16(ag);
  const float e = round_bf16(expf(-a));
  const float d = round_bf16(1.0f + e);
  const float r = round_bf16(1.0f / d);
  return __fmul_rn(round_bf16(__fmul_rn(a, r)), b);
}

// The body of both kernels: NW = 2 weights with the SwiGLU epilogue (the
// up-projection), or 1 (the down-projection). a_rows (nullable: the slot
// itself) picks each slot's row of A; out_rows (nullable: the slot itself)
// its row of out.
template <int MT, int NW>
__device__ __forceinline__ void expert_body(
    const __nv_bfloat16* __restrict__ A, const int* __restrict__ a_rows,
    const int8_t* const (&Wq)[NW], const float* const (&Ws)[NW], __nv_bfloat16* __restrict__ out,
    const int* __restrict__ out_rows, const int* __restrict__ offsets,
    const int* __restrict__ counts, int K, int N) {
  constexpr int BM = 16 * MT;
  constexpr int STAGE = stage_bytes<BM, NW>();
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int srow[BM];

  const int e = blockIdx.z;
  const int count = counts[e];
  if (count == 0) return;
  const int off = offsets[e];
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = 32 * warp;
  const int g = lane >> 2, t = lane & 3;

  const size_t plane = static_cast<size_t>(K) * N;
  const int8_t* W[NW];
  float scale[NW][4];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    W[w] = Wq[w] + e * plane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wc + 4 * g + j;
      scale[w][j] = n < N ? Ws[w][static_cast<size_t>(e) * N + n] : 0.0f;
    }
  }
  const int KT = (K + BK - 1) / BK;

  for (int m0 = blockIdx.x * BM; m0 < count; m0 += gridDim.x * BM) {
    __syncthreads();   // the previous M tile is done with srow and the ring
    for (int r = tid; r < BM; r += THREADS) {
      const int m = m0 + r;
      srow[r] = m < count ? (a_rows ? a_rows[off + m] : off + m) : -1;
    }
    __syncthreads();
    float acc[NW][MT][4][4];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[w][mt][j][i] = 0.0f;

#pragma unroll
    for (int s = 0; s < RING - 1; ++s) {
      if (s < KT) load_stage<BM, NW>(smem + s * STAGE, A, srow, W, K, N, n0, s * BK, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<RING - 2>();
      __syncthreads();   // stage kt landed for all; stage kt - 1 is free
      const int next = kt + RING - 1;
      if (next < KT)
        load_stage<BM, NW>(smem + (next % RING) * STAGE, A, srow, W, K, N, n0, next * BK,
                           tid);
      cp_async_commit();
      compute_stage<MT, NW>(smem + (kt % RING) * STAGE, wc, lane, scale, acc);
    }
    cp_async_wait<0>();

    // lane (g, t) holds rows g and g + 8 of each m-tile at columns
    // wc + 8t .. wc + 8t + 7: n-tile j's two columns are 8t + j and 8t + 4 + j
    const int n = n0 + wc + 8 * t;
    if (n >= N) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + 16 * mt + g + 8 * half;
        if (m >= count) continue;
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (NW == 2) {
            v[j] = swiglu(acc[0][mt][j][2 * half], acc[1][mt][j][2 * half]);
            v[4 + j] = swiglu(acc[0][mt][j][2 * half + 1], acc[1][mt][j][2 * half + 1]);
          } else {
            v[j] = acc[0][mt][j][2 * half];
            v[4 + j] = acc[0][mt][j][2 * half + 1];
          }
        }
        uint4 packed;
        packed.x = pack_bf16(v[0], v[1]);
        packed.y = pack_bf16(v[2], v[3]);
        packed.z = pack_bf16(v[4], v[5]);
        packed.w = pack_bf16(v[6], v[7]);
        const int row = out_rows ? out_rows[off + m] : off + m;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + n) = packed;
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
    moe_expert_swiglu_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ rows,
                             const int8_t* __restrict__ wi, const float* __restrict__ si,
                             const int8_t* __restrict__ wg, const float* __restrict__ sg,
                             __nv_bfloat16* __restrict__ h, const int* __restrict__ offsets,
                             const int* __restrict__ counts, int D, int F) {
  const int8_t* const Wq[2] = {wi, wg};
  const float* const Ws[2] = {si, sg};
  expert_body<MT, 2>(x, rows, Wq, Ws, h, nullptr, offsets, counts, D, F);
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
    moe_expert_down_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ pairs,
                           const int8_t* __restrict__ wo, const float* __restrict__ so,
                           __nv_bfloat16* __restrict__ out, const int* __restrict__ offsets,
                           const int* __restrict__ counts, int F, int D) {
  const int8_t* const Wq[1] = {wo};
  const float* const Ws[1] = {so};
  expert_body<MT, 1>(h, nullptr, Wq, Ws, out, pairs, offsets, counts, F, D);
}

// Launch `kernel` over (slices, N / BN tiles, E experts) with the ring's
// shared memory, allowed once per instantiation.
template <int MT, int NW, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int slices, int E, int N, cudaStream_t s,
           Args... args) {
  constexpr int smem = RING * stage_bytes<16 * MT, NW>();
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid(slices, (N + BN - 1) / BN, E);
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, D) bf16; rows (P,) int32, the row of x of each sorted slot;
// wi, wg (E, D, F) int8 with si, sg (E, F) f32; h (P, F) bf16, by slot;
// offsets, counts (E,) int32. bm 16 or 64 rows per M tile; slices >= 1
// blocks side by side over each expert's M tiles. D and F multiples of 16,
// x, the codes and h 16-byte aligned.
extern "C" int moe_expert_swiglu_launch(const void* x, const void* rows, const void* wi,
                                        const void* si, const void* wg, const void* sg, void* h,
                                        const void* offsets, const void* counts, int E, int D,
                                        int F, int bm, int slices, void* stream) {
  const auto* X = static_cast<const __nv_bfloat16*>(x);
  const auto* R = static_cast<const int*>(rows);
  const auto* Wi = static_cast<const int8_t*>(wi);
  const auto* Wg = static_cast<const int8_t*>(wg);
  const auto* Si = static_cast<const float*>(si);
  const auto* Sg = static_cast<const float*>(sg);
  auto* H = static_cast<__nv_bfloat16*>(h);
  const auto* O = static_cast<const int*>(offsets);
  const auto* C = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 || F % 16 || slices < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16)
    return launch<1, 2>(moe_expert_swiglu_kernel<1>, slices, E, F, s, X, R, Wi, Si, Wg, Sg, H,
                        O, C, D, F);
  if (bm == 64)
    return launch<4, 2>(moe_expert_swiglu_kernel<4>, slices, E, F, s, X, R, Wi, Si, Wg, Sg, H,
                        O, C, D, F);
  return static_cast<int>(cudaErrorInvalidValue);
}

// h (P, F) bf16, by slot; pairs (P,) int32, the pair of each slot; wo (E,
// F, D) int8 with so (E, D) f32; out (P, D) bf16, in pair order; offsets,
// counts, bm, slices as above.
extern "C" int moe_expert_down_launch(const void* h, const void* pairs, const void* wo,
                                      const void* so, void* out, const void* offsets,
                                      const void* counts, int E, int F, int D, int bm,
                                      int slices, void* stream) {
  const auto* H = static_cast<const __nv_bfloat16*>(h);
  const auto* Pr = static_cast<const int*>(pairs);
  const auto* Wo = static_cast<const int8_t*>(wo);
  const auto* So = static_cast<const float*>(so);
  auto* Out = static_cast<__nv_bfloat16*>(out);
  const auto* O = static_cast<const int*>(offsets);
  const auto* C = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 16 || F % 16 || slices < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 16)
    return launch<1, 1>(moe_expert_down_kernel<1>, slices, E, D, s, H, Pr, Wo, So, Out, O, C,
                        F, D);
  if (bm == 64)
    return launch<4, 1>(moe_expert_down_kernel<4>, slices, E, D, s, H, Pr, Wo, So, Out, O, C,
                        F, D);
  return static_cast<int>(cudaErrorInvalidValue);
}
