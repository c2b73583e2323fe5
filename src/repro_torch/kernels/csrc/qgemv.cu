// Int8-weight GEMV with f32 activations: the weight-only product of a
// decode-shaped batch.
//
// Replaces: src/repro/kernels/qdot_serve.py::qgemv (_qgemv_kernel), the
// Pallas kernel with one program per 256-wide N stripe that holds all of K
// and the whole (B, K) activation in VMEM.
//
//   out[b, n] = (sum_k x[b, k] * float(w[k, n])) * scale[n]
//
// The sum is finished before the scale is applied, as the Pallas kernel's
// (x @ w) * s does; folding the scale into the weights would round otherwise.
//
// Bound on this card: the int8 weights are read once (K*N bytes) and the
// product is 2*B*K*N f32 operations on the CUDA cores. At B = 8 the
// operations take about 78% of the byte time, so both count; below that the
// bytes bound it.
//
// Design (simple first):
// - A block owns 128 columns and a range of K. Lane l of a warp reads the 4
//   int8 weights n0 + 4l .. n0 + 4l + 3 of one row as one 32-bit word, so a
//   warp reads one 128-byte row segment; the block's 8 warps take
//   interleaved rows of its range. Each lane keeps two batches of 8 words in
//   flight: the next batch loads while the current one is used.
// - Each weight is widened to f32 once and used for up to RB = 8 rows of x,
//   whose sums sit in registers. The widening is a byte permute and one
//   subtract (exact, -128 included): the int-to-float unit runs at an eighth
//   of the FMA rate, which at B = 8 would double the arithmetic time.
// - x does not fit in shared memory whole (180 KB at B = 8, K = 5632): the
//   block stages KT = 512 of its k at a time, transposed to [k][row] so that
//   a lane reads the RB values of one k as broadcast float4s.
// - The 8 warps' sums are added in shared memory (the same buffer) in warp
//   order.
// - Enough blocks to fill the card: where the 128-wide stripes times the
//   row chunks are fewer than a few per SM, K is split across blocks (the
//   wrapper's plan, kernels/qdot_serve.py). Each split writes its sums to a
//   scratch buffer and a second kernel adds them in split order and applies
//   the scale. No atomics: two launches on the same inputs give the same bits.
// - Any B >= 1: rows in chunks of RB (1, 2, 4 or 8) on grid z; rows past B
//   are staged as zeros and not stored.
// Not yet: 16-byte weight loads, cp.async or TMA pipelining, a combine fused
// into the last split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TN = 128;       // columns per block: 32 lanes x 4
constexpr int KT = 512;       // k values of x staged per step
constexpr int UNROLL = 8;     // weight words per lane per batch
constexpr int STEP = WARPS * UNROLL;

// Batch of UNROLL weight words of this lane: rows j0, j0 + 8, ... of the
// staged step, 0 past kt.
__device__ __forceinline__ void load_batch(int32_t (&wv)[UNROLL], const int8_t* wrow,
                                           int j0, int kt, int N) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + u * WARPS;
    wv[u] = j < kt ? __ldg(reinterpret_cast<const int32_t*>(
                         wrow + static_cast<size_t>(j) * N))
                   : 0;
  }
}

// The 4 signed bytes of w as exact floats, without the int-to-float unit:
// byte b + 128 placed under the exponent of 2^23 gives the float 2^23 + 128
// + b, and subtracting 2^23 + 128 leaves b (-128 included).
__device__ __forceinline__ void widen(int32_t w, float (&f)[4]) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    f[c] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | c)), 8388736.0f);
}

template <int RB>
__global__ void __launch_bounds__(THREADS)
qgemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ dst,
             int B, int K, int N, int kchunk) {
  // the staged x during the k loop, the warps' sums after it
  constexpr int SMEM = KT * RB > WARPS * RB * TN ? KT * RB : WARPS * RB * TN;
  __shared__ __align__(16) float smem[SMEM];
  float* xs = smem;                                        // [KT][RB]
  float (*red)[RB][TN] = reinterpret_cast<float (*)[RB][TN]>(smem);  // [WARPS][RB][TN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int b0 = blockIdx.z * RB;
  const int8_t* wcol = w + n0 + 4 * lane;

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    const int kt = min(KT, k_end - k0);
    const int8_t* wrow = wcol + static_cast<size_t>(k0) * N;
    int32_t cur[UNROLL], nxt[UNROLL];
    load_batch(cur, wrow, warp, kt, N);      // in flight while x is staged
    if (k0 != k_begin) __syncthreads();      // the last step's reads of xs are done
    for (int i = threadIdx.x; i < RB * KT; i += THREADS) {
      const int r = i / KT, j = i % KT;
      xs[j * RB + r] = (b0 + r < B && j < kt)
                           ? x[static_cast<size_t>(b0 + r) * K + k0 + j] : 0.0f;
    }
    __syncthreads();
    for (int j0 = warp; j0 < kt; j0 += STEP) {
      load_batch(nxt, wrow, j0 + STEP, kt, N);   // the next batch in flight
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * WARPS;
        if (j >= kt) break;
        float wf[4];
        widen(cur[u], wf);
        float xv[RB];
        if constexpr (RB % 4 == 0) {
#pragma unroll
          for (int q = 0; q < RB / 4; ++q) {
            const float4 t = reinterpret_cast<const float4*>(xs + j * RB)[q];
            xv[4 * q] = t.x; xv[4 * q + 1] = t.y; xv[4 * q + 2] = t.z; xv[4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r) xv[r] = xs[j * RB + r];
        }
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], wf[c], acc[r][c]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
    }
  }
  __syncthreads();                            // every warp is done with xs

#pragma unroll
  for (int r = 0; r < RB; ++r)
    *reinterpret_cast<float4*>(&red[warp][r][4 * lane]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < RB * TN; i += THREADS) {
    const int r = i / TN, c = i % TN;
    const int b = b0 + r, n = n0 + c;
    if (b >= B) continue;
    float s = red[0][r][c];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) s = __fadd_rn(s, red[v][r][c]);
    if (gridDim.y == 1)
      dst[static_cast<size_t>(b) * N + n] = __fmul_rn(s, scale[n]);
    else
      dst[(static_cast<size_t>(blockIdx.y) * B + b) * N + n] = s;
  }
}

// out[b, n] = (sum over splits, in split order, of part[p, b, n]) * scale[n]
__global__ void __launch_bounds__(256)
qgemv_combine(const float* __restrict__ part, const float* __restrict__ scale,
              float* __restrict__ out, int B, int N, int splits) {
  const size_t total = static_cast<size_t>(B) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, part[static_cast<size_t>(p) * total + i]);
    out[i] = __fmul_rn(s, scale[i % N]);
  }
}

}  // namespace

extern "C" int qgemv_launch(const void* x, const void* w, const void* scale, void* out,
                            void* partial, int B, int K, int N, int rb, int kchunk,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* X = static_cast<const float*>(x);
  const auto* W = static_cast<const int8_t*>(w);
  const auto* S = static_cast<const float*>(scale);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const dim3 grid(N / TN, splits, (B + rb - 1) / rb);
  switch (rb) {
    case 1: qgemv_kernel<1><<<grid, THREADS, 0, s>>>(X, W, S, dst, B, K, N, kchunk); break;
    case 2: qgemv_kernel<2><<<grid, THREADS, 0, s>>>(X, W, S, dst, B, K, N, kchunk); break;
    case 4: qgemv_kernel<4><<<grid, THREADS, 0, s>>>(X, W, S, dst, B, K, N, kchunk); break;
    case 8: qgemv_kernel<8><<<grid, THREADS, 0, s>>>(X, W, S, dst, B, K, N, kchunk); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * N;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  qgemv_combine<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial), S,
                                       static_cast<float*>(out), B, N, splits);
  return static_cast<int>(cudaGetLastError());
}
