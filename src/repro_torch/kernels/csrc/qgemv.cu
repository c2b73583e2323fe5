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
// Bound on this card: the int8 weights are read once (K*N bytes); the
// 2*B*K*N operations, counted at the f32 rate outside the tensor cores, take
// at most 78% of the byte time (B = 8), so the bytes bound it.
//
// Design: rows of x in chunks of rb (grid y). Chunks of 4 or 8 rows go
// through the tensor cores (qgemv_kernel), chunks of 1 or 2 through the
// CUDA cores (qgemv_cores_kernel): the tensor cores' n = 8 would do 8 rows'
// work for them.
// - Tensor cores, in exact TF32 parts: out^T = w^T x^T with
//   mma.sync.m16n8k8 (TF32 in, f32 sums). A is 16 columns of w by 8 k, each
//   int8 widened to an exact f32 (a byte permute and a subtract), hence an
//   exact TF32 value. B is x^T, 8 k by 8 rows of x, split per use into hi =
//   rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact; the rounding is
//   done on the bits), so two MMAs keep about 22 bits of x. The hi products
//   of each ring stage go to fresh sums that are then added to a running
//   sum with round-to-nearest: the tensor cores' own adds truncate, and only
//   a stage's worth of them lands on a sum. The lo products, 2^-11 smaller,
//   sum in place.
// - Fragments without bank conflicts or a repacked weight: lane (g, t) reads
//   one 32-bit word (4 columns 4g..4g+3 of one k row) of k rows 2t and
//   2t + 1 of a step (the MMA's k = t and t + 4) of its warp's 32 columns,
//   and uses byte 2j + h as row g + 8h of m-tile j: columns and k are
//   relabelled, not moved. Stage rows are swizzled in 16-byte chunks so the
//   four rows a warp reads at once fall on all 32 banks for 128-, 64- and
//   32-column stripes; x is staged as [row][k] with rows 72 floats apart, so
//   the lane's (x[g][2t], x[g][2t + 1]) is one conflict-free 8-byte read.
// - Weights and x streamed by cp.async into a ring of RING = 4 stages of 64
//   k, 16 bytes per copy (4 where w or x is not 16-byte aligned or K % 4 !=
//   0), zero past K and past B.
// - CUDA cores: a warp reads 4 k rows x 128 (or 64) columns per load, 16
//   (or 8) bytes a lane, with `depth` loads and their rows' x values in
//   flight per lane; each widened weight feeds rb fused multiply-adds into
//   f32 sums.
// - Split K reduced inside a thread-block cluster, with no second launch:
//   the CTAs of a cluster (1, 2, 4 or 8) take consecutive k ranges of one
//   stripe, whole 64-k stages, as evenly as they divide. Each CTA adds its
//   warps' sums in warp order and stores them into its slot of rank 0's
//   shared memory (distributed shared memory); after one cluster barrier
//   rank 0 adds the slots in rank order, applies the scale and stores. No
//   scratch in device memory, no atomics, no counter: the order of every
//   add is fixed, so two launches give the same bits.
// - The plan (kernels/qdot_serve.py::plan, pure Python): the row chunk, the
//   stripe width, the cluster size (hence the k range per CTA) and, on the
//   CUDA cores, the loads in flight. The ring's 4 stages were the fastest
//   of a sweep (kernel_sweep.py --sweep, which builds 3 by defining
//   QGEMV_RING).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KS = 64;             // k rows per ring stage
constexpr int RB = 8;              // rows of x per MMA (its n)
constexpr int XSTRIDE = KS + 8;    // floats per staged row of x: 8-byte reads conflict-free
#ifndef QGEMV_RING
#define QGEMV_RING 4
#endif
constexpr int RING = QGEMV_RING;   // tensor cores: ring stages, RING - 1 in flight
constexpr int MAX_CLUSTER = 8;     // CTAs per cluster, at most (the portable maximum)

template <int TN>
__host__ __device__ constexpr int stage_bytes() { return KS * TN + 4 * RB * XSTRIDE; }

// Byte offset of byte `col` of k row r in a stage's TN-column weight tile:
// 128-byte lines of 128 / TN rows, the 16-byte chunk index within the line
// XORed with 2 * key(r), which puts the four rows 2t + h (t = 0..3) that a
// warp reads at once on disjoint chunk pairs.
template <int TN>
__device__ __forceinline__ int w_offset(int r, int col) {
  constexpr int RPL = 128 / TN;
  const int line = r / RPL, p = r % RPL;
  const int key = RPL == 4 ? (r >> 2) & 1 : (r >> 1) & 3;
  const int chunk = (p * (TN / 16) + (col >> 4)) ^ (2 * key);
  return 128 * line + 16 * chunk + (col & 15);
}

// Up to 16 bytes from device to shared memory, asynchronously: `bytes` of
// them copied, the rest of the 16 zero.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(i8mma::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes from device to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(i8mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Stage k rows [k0, k0 + KS) of the stripe's weights and of x (rows b0 ..
// b0 + rb - 1, as [row][k] with XSTRIDE floats a row), zeros at k >= ke and
// at rows past B. VEC: w and x are 16-byte aligned and K % 4 == 0, so every
// copy takes 16 bytes; else 4.
template <int TN, bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* st, const float* __restrict__ x,
                                           const int8_t* __restrict__ w, int B, int K, int N,
                                           int n0, int b0, int rb, int k0, int ke, int tid) {
  constexpr int CH = TN / 16;
#pragma unroll
  for (int q = tid; q < KS * CH; q += THREADS) {
    const int r = q / CH, c = q % CH;
    const bool ok = k0 + r < ke;
    uint8_t* dst = st + w_offset<TN>(r, 16 * c);
    const int8_t* src = w + static_cast<size_t>(ok ? k0 + r : 0) * N + n0 + 16 * c;
    if constexpr (VEC) {
      i8mma::cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(dst + 4 * j, src + 4 * j, ok);
    }
  }
  float* xs = reinterpret_cast<float*>(st + KS * TN);
  if constexpr (VEC) {
#pragma unroll
    for (int q = tid; q < RB * KS / 4; q += THREADS) {
      const int g = q / (KS / 4), k = k0 + 4 * (q % (KS / 4));
      const int bytes = g < rb && b0 + g < B ? 4 * max(0, min(4, ke - k)) : 0;
      cp_async16_part(xs + g * XSTRIDE + (k - k0),
                      bytes ? x + static_cast<size_t>(b0 + g) * K + k : x, bytes);
    }
  } else {
#pragma unroll
    for (int q = tid; q < RB * KS; q += THREADS) {
      const int g = q / KS, k = k0 + q % KS;
      const bool ok = k < ke && g < rb && b0 + g < B;
      cp_async4(xs + g * XSTRIDE + (k - k0), x + (ok ? static_cast<size_t>(b0 + g) * K + k : 0),
                ok);
    }
  }
}

// The 4 signed bytes of w as exact floats, without the int-to-float unit:
// byte b + 128 placed under the exponent of 2^23 gives the float 2^23 + 128
// + b, and subtracting 2^23 + 128 leaves b (-128 included).
__device__ __forceinline__ void widen(uint32_t w, uint32_t* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    f[c] = __float_as_uint(
        __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | c)), 8388736.0f));
}

// f32 to TF32, round to nearest with ties away from zero (cvt.rna.tf32.f32),
// on the bits: add half a unit of the 13 dropped bits to the magnitude.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & ~0x1FFFu;
}

// d += a (16 x 8, TF32) @ b (8 x 8, TF32), f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cluster's reduction, shared by both kernels. Every thread arrives at
// the cluster barrier when its CTA starts (relaxed, it does not wait), so
// that `push` can wait for every CTA of the cluster to have started before
// it stores into rank 0's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Each rank stores its `elems` sums (`sums`, this CTA's shared memory) into
// its slot of rank 0's `slots` (the same offset in every CTA), then one
// cluster barrier; rank 0 adds the slots in rank order, applies the scale
// and stores rows 0 .. rows - 1 of its (rows x tn) block of out at (b0, n0).
template <int NT>
__device__ __forceinline__ void push(cg::cluster_group& cluster, const float* sums, float* slots,
                                     int elems, int tn, int rows, const float* __restrict__ scale,
                                     float* __restrict__ out, int N, int b0, int n0) {
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float* dst = cluster.map_shared_rank(slots, 0) + rank * elems;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");      // all CTAs started
  for (int e = threadIdx.x; e < elems; e += NT) dst[e] = sums[e];
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // all slots written
  if (rank != 0) return;
  for (int e = threadIdx.x; e < rows * tn; e += NT) {
    float v = slots[e];
    for (int r = 1; r < C; ++r) v = __fadd_rn(v, slots[r * elems + e]);
    const int b = e / tn, n = n0 + e % tn;
    out[static_cast<size_t>(b0 + b) * N + n] = __fmul_rn(v, scale[n]);
  }
}

template <int TN, bool VEC>
__global__ void __launch_bounds__(THREADS)
qgemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, int B, int K, int N,
             int rb) {
  constexpr int SB = stage_bytes<TN>();
  constexpr int CGS = TN / 32;            // column groups of 32 (2 m-tiles)
  constexpr int KSL = WARPS / CGS;        // warps along k within a stage
  constexpr int SPW = (KS / 8) / KSL;     // k steps of 8 per warp per stage
  extern __shared__ __align__(16) uint8_t smem[];   // the ring, then the cluster's slots
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cgi = warp % CGS, ksl = warp / CGS;
  const int n0 = (blockIdx.x / C) * TN;
  const int b0 = blockIdx.y * rb;
  const int steps = (K + KS - 1) / KS;   // stages of K, rank r takes [r S / C, (r + 1) S / C)
  const int kb = rank * steps / C * KS;
  const int ke = min(K, (rank + 1) * steps / C * KS);
  const int nst = ke > kb ? (ke - kb + KS - 1) / KS : 0;

  float run[2][4], lo[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) run[j][c] = lo[j][c] = 0.0f;

#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < nst)
      load_stage<TN, VEC>(smem + i * SB, x, w, B, K, N, n0, b0, rb, kb + i * KS, ke, tid);
    i8mma::cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    i8mma::cp_async_wait<RING - 2>();
    __syncthreads();                      // stage it landed; slot it - 1 is free
    const int nx = it + RING - 1;
    if (nx < nst)
      load_stage<TN, VEC>(smem + (nx % RING) * SB, x, w, B, K, N, n0, b0, rb,
                          kb + nx * KS, ke, tid);
    i8mma::cp_async_commit();

    const uint8_t* st = smem + (it % RING) * SB;
    const float* xs = reinterpret_cast<const float*>(st + KS * TN);
    float hi[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[j][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int s = ksl * SPW + i;
      // k rows 8s + 2t and 8s + 2t + 1 are the MMA's k = t and k = t + 4
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
          st + w_offset<TN>(8 * s + 2 * t, 32 * cgi + 4 * g));
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          st + w_offset<TN>(8 * s + 2 * t + 1, 32 * cgi + 4 * g));
      uint32_t f0[4], f1[4];
      widen(w0, f0);
      widen(w1, f1);
      const float2 xv = *reinterpret_cast<const float2*>(xs + g * XSTRIDE + 8 * s + 2 * t);
      const uint32_t h0 = to_tf32(xv.x), h1 = to_tf32(xv.y);
      const uint32_t l0 = to_tf32(__fsub_rn(xv.x, __uint_as_float(h0)));
      const uint32_t l1 = to_tf32(__fsub_rn(xv.y, __uint_as_float(h1)));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a[4] = {f0[2 * j], f0[2 * j + 1], f1[2 * j], f1[2 * j + 1]};
        mma_tf32(hi[j], a, h0, h1);
        mma_tf32(lo[j], a, l0, l1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[j][c] = __fadd_rn(run[j][c], hi[j][c]);
  }
  i8mma::cp_async_wait<0>();
  __syncthreads();                        // every warp is done with the ring

  // red[ksl][b][n]: each warp's sums; then red[0] = their sum in warp order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 32 * cgi + 4 * g + 2 * j + (c >> 1), b = 2 * t + (c & 1);
      red[(ksl * RB + b) * TN + n] = __fadd_rn(run[j][c], lo[j][c]);
    }
  __syncthreads();
  for (int e = tid; e < RB * TN; e += THREADS) {
    float v = red[e];
#pragma unroll
    for (int s = 1; s < KSL; ++s) v = __fadd_rn(v, red[s * RB * TN + e]);
    red[e] = v;
  }
  __syncthreads();
  push<THREADS>(cluster, red, reinterpret_cast<float*>(smem + RING * SB), RB * TN, TN,
                min(rb, B - b0), scale, out, N, b0, n0);
}

// The rows of x of one row chunk of 1 or 2 on the CUDA cores: the tensor
// cores' n = 8 would do 8 rows' work for them. A warp reads 4 k rows x 8L
// columns per load, L bytes a lane (L = 16 or 8: 128- or 64-column
// stripes): lane (r, c) = (lane / 8, lane % 8) owns columns Lc .. Lc + L - 1
// of the stripe in rows 4i + r (4-byte loads where w is not L-byte
// aligned). The 8 warps of a CTA take interleaved groups of 4 rows of its k
// range, D loads (and the x values of their rows) in flight per lane. Each
// widened weight feeds R fused multiply-adds into f32 sums; the 4 row
// groups of a warp are then added by a fixed xor butterfly.
constexpr int CORES_WARPS = 8;
constexpr int CORES_THREADS = 32 * CORES_WARPS;

template <int R, int L, bool VEC, int D>
__global__ void __launch_bounds__(CORES_THREADS)
qgemv_cores_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out, int B, int K,
                   int N) {
  constexpr int TNC = 8 * L;              // columns per stripe
  constexpr int WORDS = L / 4;
  constexpr int STEP = 4 * CORES_WARPS;   // rows per load of the CTA's warps together
  __shared__ __align__(16) float red[CORES_WARPS][R][TNC];
  __shared__ float slots[MAX_CLUSTER * R * TNC];    // rank 0's: every rank's sums
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, cg8 = lane & 7;
  const int n0 = (blockIdx.x / C) * TNC, b0 = blockIdx.y * R;
  const int steps = (K + KS - 1) / KS;
  const int kb = rank * steps / C * KS, ke = min(K, (rank + 1) * steps / C * KS);
  const int8_t* wp = w + n0 + L * cg8;
  const float* xp[R];
#pragma unroll
  for (int b = 0; b < R; ++b) xp[b] = b0 + b < B ? x + static_cast<size_t>(b0 + b) * K : nullptr;

  float acc[R][L];
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int c = 0; c < L; ++c) acc[b][c] = 0.0f;
  uint32_t wv[D][WORDS];
  float xv[D][R];
  auto load = [&](int i, int k) {            // slot i: this lane's part of row k
#pragma unroll
    for (int q = 0; q < WORDS; ++q) wv[i][q] = 0u;
#pragma unroll
    for (int b = 0; b < R; ++b) xv[i][b] = 0.0f;
    if (k < ke) {
      const int8_t* src = wp + static_cast<size_t>(k) * N;
      if constexpr (VEC && L == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        wv[i][0] = v.x; wv[i][1] = v.y; wv[i][2] = v.z; wv[i][3] = v.w;
      } else if constexpr (VEC) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        wv[i][0] = v.x; wv[i][1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < WORDS; ++q) wv[i][q] = __ldg(reinterpret_cast<const uint32_t*>(src) + q);
      }
#pragma unroll
      for (int b = 0; b < R; ++b)
        if (xp[b] != nullptr) xv[i][b] = __ldg(xp[b] + k);
    }
  };
  const int k1 = kb + 4 * warp + rg;          // this lane's first row
#pragma unroll
  for (int i = 0; i < D; ++i) load(i, k1 + STEP * i);
  for (int k0 = kb + 4 * warp; k0 < ke; k0 += STEP * D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      uint32_t f[L];
#pragma unroll
      for (int q = 0; q < WORDS; ++q) widen(wv[i][q], f + 4 * q);
#pragma unroll
      for (int b = 0; b < R; ++b)
#pragma unroll
        for (int c = 0; c < L; ++c) acc[b][c] = fmaf(xv[i][b], __uint_as_float(f[c]), acc[b][c]);
      load(i, k0 + rg + STEP * (i + D));
    }
  }
  // rows 4i + r: (r0 + r1) + (r2 + r3), the same bits on every lane of a column
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int c = 0; c < L; ++c) {
      acc[b][c] = __fadd_rn(acc[b][c], __shfl_xor_sync(0xffffffffu, acc[b][c], 8));
      acc[b][c] = __fadd_rn(acc[b][c], __shfl_xor_sync(0xffffffffu, acc[b][c], 16));
    }
  if (rg == 0)
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int q = 0; q < L / 4; ++q)
        *reinterpret_cast<float4*>(&red[warp][b][L * cg8 + 4 * q]) =
            make_float4(acc[b][4 * q], acc[b][4 * q + 1], acc[b][4 * q + 2], acc[b][4 * q + 3]);
  __syncthreads();
  for (int e = tid; e < R * TNC; e += CORES_THREADS) {     // the warps in order
    float v = (&red[0][0][0])[e];
#pragma unroll
    for (int q = 1; q < CORES_WARPS; ++q) v = __fadd_rn(v, (&red[q][0][0])[e]);
    (&red[0][0][0])[e] = v;
  }
  __syncthreads();
  push<CORES_THREADS>(cluster, &red[0][0][0], slots, R * TNC, TNC, min(R, B - b0), scale, out,
                      N, b0, n0);
}

// Launch `kernel` on grid (stripes x cluster, row chunks) in clusters of
// `cluster` CTAs along x.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int stripes, int cluster, int chunks, int threads,
                    int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(stripes * cluster, chunks, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int TN, bool VEC>
int launch_mma(const float* x, const int8_t* w, const float* scale, float* out, int B, int K,
               int N, int rb, int cluster, cudaStream_t s) {
  constexpr int smem_max = RING * stage_bytes<TN>() + MAX_CLUSTER * RB * TN * 4;
  // set once for this instantiation, to what the largest cluster needs
  static const cudaError_t allowed = cudaFuncSetAttribute(
      qgemv_kernel<TN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const int smem = RING * stage_bytes<TN>() + cluster * RB * TN * 4;
  return launch_clusters(qgemv_kernel<TN, VEC>, N / TN, cluster, (B + rb - 1) / rb, THREADS,
                         smem, s, x, w, scale, out, B, K, N, rb);
}

template <int TN>
int launch_tensor(const float* x, const int8_t* w, const float* scale, float* out, int B, int K,
                  int N, int rb, int cluster, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      K % 4 == 0)
    return launch_mma<TN, true>(x, w, scale, out, B, K, N, rb, cluster, s);
  return launch_mma<TN, false>(x, w, scale, out, B, K, N, rb, cluster, s);
}

template <int R, int L, int D>
int launch_cores(const float* x, const int8_t* w, const float* scale, float* out, int B, int K,
                 int N, int cluster, cudaStream_t s) {
  const int stripes = N / (8 * L), chunks = (B + R - 1) / R;
  if (reinterpret_cast<uintptr_t>(w) % L == 0)
    return launch_clusters(qgemv_cores_kernel<R, L, true, D>, stripes, cluster, chunks,
                           CORES_THREADS, 0, s, x, w, scale, out, B, K, N);
  return launch_clusters(qgemv_cores_kernel<R, L, false, D>, stripes, cluster, chunks,
                         CORES_THREADS, 0, s, x, w, scale, out, B, K, N);
}

template <int L>
int launch_cores_depth(int rb, int depth, const float* x, const int8_t* w, const float* scale,
                       float* out, int B, int K, int N, int cluster, cudaStream_t s) {
  switch (depth * 4 + rb) {
    case 4 * 4 + 1: return launch_cores<1, L, 4>(x, w, scale, out, B, K, N, cluster, s);
    case 4 * 4 + 2: return launch_cores<2, L, 4>(x, w, scale, out, B, K, N, cluster, s);
    case 8 * 4 + 1: return launch_cores<1, L, 8>(x, w, scale, out, B, K, N, cluster, s);
    case 8 * 4 + 2: return launch_cores<2, L, 8>(x, w, scale, out, B, K, N, cluster, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, K) f32, w (K, N) int8 (4-byte aligned), scale (N,) f32, out (B, N)
// f32, contiguous on the device; N a multiple of 256. rb rows of x per grid
// row: 4 or 8 on the tensor cores, with tn columns per stripe (128, 64 or
// 32) and depth == RING; 1 or 2 on the CUDA cores, with tn columns per
// stripe (128 or 64) and depth loads in flight per lane (4 or 8).
// cluster CTAs (1, 2, 4 or 8) along K, each taking whole 64-k stages.
extern "C" int qgemv_launch(const void* x, const void* w, const void* scale, void* out, int B,
                            int K, int N, int rb, int tn, int cluster, int depth,
                            void* stream) {
  const auto* X = static_cast<const float*>(x);
  const auto* Wq = static_cast<const int8_t*>(w);
  const auto* S = static_cast<const float*>(scale);
  auto* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 256 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rb == 1 || rb == 2) {
    if (tn == 128) return launch_cores_depth<16>(rb, depth, X, Wq, S, O, B, K, N, cluster, s);
    if (tn == 64) return launch_cores_depth<8>(rb, depth, X, Wq, S, O, B, K, N, cluster, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((rb != 4 && rb != RB) || depth != RING) return static_cast<int>(cudaErrorInvalidValue);
  switch (tn) {
    case 128: return launch_tensor<128>(X, Wq, S, O, B, K, N, rb, cluster, s);
    case 64: return launch_tensor<64>(X, Wq, S, O, B, K, N, rb, cluster, s);
    case 32: return launch_tensor<32>(X, Wq, S, O, B, K, N, rb, cluster, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
