// Block-native paged decode attention over the KV block pool, split over the
// block table (flash-decoding).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention
// (_paged_kernel), the Pallas kernel the reference calls from
// models/attention.py::paged_decode_attention.
//
// For slot b and query head h = g * rep + r (GQA folded as (KV, rep, hd)):
//   out[b, h] = softmax_j(q[b, h] . K[j, g] * sm_scale) @ V[j, g]
// over sequence positions j <= index[b], where position j lives in pool cell
// (tables[b, j / bs], j % bs). Positions past index[b] get weight exactly 0.
//
// Bound on this card: each call reads every valid K/V cell of every slot
// once and does ~4*H*hd f32 operations per position, far below the ridge
// point, so the pool bytes it reads bound it (3.35 TB/s). At the serving
// shape (0.4 MB: 8 slots of up to 160 positions) latency is the real limit,
// and at a 2048-token context (16.8 MB) the f32 math on the CUDA cores
// costs about as much as the loads.
//
// Design:
// - Split over the table. The grid is (splits, H / heads, B): each block
//   takes one slot, `heads` query heads of one KV group (up to 8: one K/V
//   load serves them all) and a fixed contiguous run of `per` table
//   entries. The plan (kernels/paged_attention.py::plan) comes from
//   (MB, bs, H, KV) alone, never from B or index, so a slot's reduction
//   order does not depend on how many slots share the call. A split that
//   starts past the slot's horizon reads nothing and leaves m = NEG_INF,
//   l = 0, acc = 0.
// - 4 warps a block; a lane group of LPR = hd * size / 16 lanes holds one
//   K/V row (hd 64 bf16: 8 lanes of 16 bytes), a warp 32 / LPR rows at a
//   time, each lane group ROWS rows a step. Each thread copies its own 16
//   bytes of K and V with cp.async into its own slots of a shared-memory
//   ring, the next step's copies in flight while this step is computed: no
//   barrier in the loop, no registers held by copies in flight.
// - Scores: each lane multiplies its q slices (f32, in registers, scaled
//   by sm_scale * log2(e)) by its 8 K values for every head, then a
//   reduce-scatter across the group leaves each lane the whole score of one
//   head. That lane alone keeps the head's online softmax (max m, sum l, in
//   the log2 domain, m moved only when a score passes it by 2^RESCALE), and
//   the weights reach the group's other lanes by shuffles for the
//   weighted V sum, which every lane keeps for its dims of every head.
// - Merge: the lane groups of a warp by an xor butterfly, the 4 warps in
//   warp order through shared memory. One split: the block writes the
//   output. More: it writes its (m, l, acc) partial to scratch from the
//   wrapper, and a second kernel over (B, H), launched as a programmatic
//   dependent of the first, folds the partials in split order and divides
//   by l. No atomics, no order that depends on scheduling: two launches
//   give the same bits.
// - No synchronisation, no host read of device values: the pair can be
//   captured in a CUDA graph.
// Not yet: TMA bulk copies of whole pool blocks, a persistent grid, and
// the combine folded into the last split to finish (it needs counters that
// outlive a call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 2;              // positions a lane group takes per step
constexpr int STAGES = 2;            // steps in each thread's copy ring
constexpr int RING_BYTES = STAGES * ROWS * 2 * THREADS * 16;
// the copy ring, or the warps' accumulators after it (hd <= lpr * 8), if larger
constexpr int smem_bytes(int lpr, int heads) {
  return RING_BYTES > WARPS * heads * lpr * 8 * 4 ? RING_BYTES : WARPS * heads * lpr * 8 * 4;
}
constexpr int MAX_SPLITS = 16;       // at most one lane of the combine's warp each
constexpr float NEG_INF = -1e30f;
constexpr float RESCALE = 8.f;       // log2 of the largest weight before a rescale
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of a pool row as f32: 8 bf16 or 4 f32 values.
template <typename T> struct Row;
template <> struct Row<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[VEC]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);             // element 2i: low half
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Row<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[VEC]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int LPR, int HEADS>
__global__ void __launch_bounds__(THREADS, 3)
paged_attention_split(const float* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool, const int* __restrict__ tables,
                      const int* __restrict__ index, float* __restrict__ out,
                      float* __restrict__ partial, int H, int KV, int bs, int MB,
                      int n_blocks, int per, float sm_scale) {
  constexpr int VEC = Row<T>::VEC;
  constexpr int HD = LPR * VEC;
  constexpr int RG = 32 / LPR;              // rows a warp holds at once
  constexpr int STEP = WARPS * RG * ROWS;   // positions the block takes per step
  // each thread's own ring of row slices: it alone writes and reads them
  extern __shared__ __align__(16) uint4 smem_ring[];
  auto ring = reinterpret_cast<uint4 (*)[ROWS][2][THREADS]>(smem_ring);
  __shared__ float m_s[WARPS][HEADS], l_s[WARPS][HEADS];
  // the warps' accumulators reuse the ring once every thread is done with it
  auto acc_s = reinterpret_cast<float (*)[HEADS][HD]>(&ring[0][0][0][0]);

  // the combine may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x, n_split = gridDim.x;
  const int h0 = blockIdx.y * HEADS, b = blockIdx.z;
  const int g = h0 / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane % LPR;                // this lane's 16 bytes of the row
  const int mine = warp * RG + lane / LPR;
  const int idx = __ldg(index + b);
  const int p0 = split * per * bs;
  const int shift = __popc(bs) == 1 ? __ffs(bs) - 1 : -1;   // bs a power of 2

  // the pool offset of this lane's slice of position p of the split; the
  // table entry is clamped into the row and the block into the pool, so
  // the load is safe before the horizon is known
  auto offset = [&](int p) {
    const int pos = p0 + p;
    const int jt = shift >= 0 ? pos >> shift : pos / bs;
    const int j = min(jt, MB - 1), t = pos - jt * bs;
    int blk = __ldg(tables + static_cast<size_t>(b) * MB + j);
    blk = min(max(blk, 0), n_blocks - 1);
    return ((static_cast<size_t>(blk) * bs + t) * KV + g) * HD + li * VEC;
  };
  auto position = [&](int s, int u) { return s * STEP + u * (WARPS * RG) + mine; };

  // scores in the log2 domain: q carries sm_scale * log2(e)
  const float c = sm_scale * 1.4426950408889634f;
  float qr[HEADS][VEC];
  const float* qb = q + (static_cast<size_t>(b) * H + h0) * HD + li * VEC;
#pragma unroll
  for (int r = 0; r < HEADS; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = __ldg(qb + r * HD + e) * c;

  size_t first[STAGES - 1][ROWS];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
#pragma unroll
    for (int u = 0; u < ROWS; ++u) first[s][u] = offset(position(s, u));

  // positions [p0, p0 + n) of the slot: this split's run, cut at the horizon
  const int last = min(idx, MB * bs - 1);
  const int n = max(0, min(last + 1 - p0, per * bs));
  const int steps = (n + STEP - 1) / STEP;

  auto issue = [&](int s, const size_t (&off)[ROWS]) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      if (position(s, u) < n) {
        cp_async16(&ring[s % STAGES][u][0][tid], k_pool + off[u]);
        cp_async16(&ring[s % STAGES][u][1][tid], v_pool + off[u]);
      }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s, first[s]);

  // Lane li of a group ends the reduction of q . k holding the score of
  // head li / GS (GS lanes share a head) and keeps that head's online
  // softmax: running max m_own and normaliser l_own. acc holds every head's
  // weighted V sum over this lane's dims.
  constexpr int GS = LPR / HEADS;
  const int base = lane - li;
  float m_own = NEG_INF, l_own = 0.f, acc[HEADS][VEC];
#pragma unroll
  for (int r = 0; r < HEADS; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    {  // step s + STAGES - 1 into the slots step s - 1 left
      size_t off[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) off[u] = offset(position(s + STAGES - 1, u));
      issue(s + STAGES - 1, off);
    }
    cp_async_wait<STAGES - 1>();            // this thread's step s has landed
    bool valid[ROWS];
    float sc[ROWS], vf[ROWS][VEC];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      valid[u] = position(s, u) < n;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 kraw = valid[u] ? ring[s % STAGES][u][0][tid] : zero;
      const uint4 vraw = valid[u] ? ring[s % STAGES][u][1][tid] : zero;
      float kf[VEC];
      Row<T>::unpack(kraw, kf);
      Row<T>::unpack(vraw, vf[u]);
      float d[HEADS];
#pragma unroll
      for (int r = 0; r < HEADS; ++r) {
        d[r] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d[r] = fmaf(qr[r][e], kf[e], d[r]);
      }
      // reduce-scatter across the group: each step halves the heads a lane
      // carries (the upper half where the offset's bit is set), until each
      // holds one; the rest add it up
      int half = HEADS / 2;
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) {
        if (half >= 1) {
          const bool upper = (lane & o) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = upper ? d[i] : d[i + half];
            const float keep = upper ? d[i + half] : d[i];
            d[i] = keep + __shfl_xor_sync(FULL, send, o);
          }
          half /= 2;
        } else {
          d[0] += __shfl_xor_sync(FULL, d[0], o);
        }
      }
      sc[u] = valid[u] ? d[0] : NEG_INF;
    }
    float m_new = m_own;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) m_new = fmaxf(m_new, sc[u]);
    // m moves only when the new max passes it by RESCALE: until then the
    // weights stay below 2^RESCALE, and acc and l share the stale m
    const bool moved = m_new > m_own + RESCALE;
    float corr = 1.f;
    if (moved) {
      corr = ex2(m_own - m_new);
      l_own *= corr;
      m_own = m_new;
    }
    if (__any_sync(FULL, moved)) {
#pragma unroll
      for (int r = 0; r < HEADS; ++r) {
        const float cr = __shfl_sync(FULL, corr, base + r * GS);   // 1 if unmoved
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= cr;
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      // explicit zero: a masked position adds nothing even while m is
      // still NEG_INF
      const float p = valid[u] ? ex2(sc[u] - m_own) : 0.f;
      l_own += p;
#pragma unroll
      for (int r = 0; r < HEADS; ++r) {
        const float pr = __shfl_sync(FULL, p, base + r * GS);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pr, vf[u][e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float m[HEADS], l[HEADS];
#pragma unroll
  for (int r = 0; r < HEADS; ++r) {
    m[r] = __shfl_sync(FULL, m_own, base + r * GS);
    l[r] = __shfl_sync(FULL, l_own, base + r * GS);
  }

  // the warp's lane groups, merged by an xor butterfly
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < HEADS; ++r) {
      const float mo = __shfl_xor_sync(FULL, m[r], o);
      const float lo = __shfl_xor_sync(FULL, l[r], o);
      const float mt = fmaxf(m[r], mo);
      const float es = ex2(m[r] - mt), eo = ex2(mo - mt);
      l[r] = l[r] * es + lo * eo;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[r][e], o);
        acc[r][e] = acc[r][e] * es + ao * eo;
      }
      m[r] = mt;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < HEADS; ++r) {
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[warp][r][li * VEC + e] = acc[r][e];
    }
  }
  __syncthreads();

  // the warps, merged in warp order
  const size_t rows = static_cast<size_t>(gridDim.z) * H * n_split;
  for (int i = tid; i < HEADS * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    float mt = m_s[0][r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, m_s[w][r]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = ex2(m_s[w][r] - mt);
      lt = fmaf(l_s[w][r], e, lt);
      at = fmaf(acc_s[w][r][d], e, at);
    }
    const size_t bh = static_cast<size_t>(b) * H + h0 + r;
    if (n_split == 1) {
      out[bh * HD + d] = at / lt;
    } else {
      const size_t row = bh * n_split + split;
      partial[row * HD + d] = at;
      if (d == 0) {
        float* ml = partial + rows * HD + 2 * row;
        ml[0] = mt;
        ml[1] = lt;
      }
    }
  }
}

// One warp per (slot, head): the splits' partials folded in split order.
// Lane s reads split s's (m, l), and every load is issued before the first
// use, so the kernel waits for one round trip to L2.
template <int PER_LANE>
__global__ void __launch_bounds__(THREADS)
paged_attention_combine(const float* __restrict__ partial, float* __restrict__ out,
                        int n_rows, int n_split, int hd) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the splits' partials
  if (row >= n_rows) return;
  const float* ml = partial + static_cast<size_t>(n_rows) * n_split * hd
                    + static_cast<size_t>(row) * n_split * 2;
  const float* acc = partial + static_cast<size_t>(row) * n_split * hd;
  const float ms = lane < n_split ? ml[2 * lane] : NEG_INF;
  const float ls = lane < n_split ? ml[2 * lane + 1] : 0.f;
  float v[PER_LANE][MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k)
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const int d = lane + 32 * k;
      v[k][s] = s < n_split && d < hd ? acc[static_cast<size_t>(s) * hd + d] : 0.f;
    }
  float mt = ms;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
  // a split wholly past the horizon has m = NEG_INF, l = 0: weight 0
  const float w = ex2(ms - mt);
  float lt = 0.f, a[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) a[k] = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    if (s < n_split) {
      const float ws = __shfl_sync(FULL, w, s);
      lt = fmaf(__shfl_sync(FULL, ls, s), ws, lt);
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) a[k] = fmaf(v[k][s], ws, a[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int d = lane + 32 * k;
    if (d < hd) out[static_cast<size_t>(row) * hd + d] = a[k] / lt;
  }
}

template <typename T, int LPR, int HEADS>
cudaError_t split_launch(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                  const void* v, const void* tables, const void* index, void* out,
                  void* partial, int H, int KV, int bs, int MB, int n_blocks, int per,
                  float sm_scale) {
  static_assert(smem_bytes(LPR, HEADS) <= 48 * 1024, "needs the opt-in to more shared memory");
  paged_attention_split<T, LPR, HEADS><<<grid, THREADS, smem_bytes(LPR, HEADS), stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(index),
      static_cast<float*>(out), static_cast<float*>(partial), H, KV, bs, MB, n_blocks,
      per, sm_scale);
  return cudaSuccess;
}

template <typename T, int LPR>
cudaError_t by_heads(int heads, dim3 grid, cudaStream_t s, const void* q, const void* k,
              const void* v, const void* tables, const void* index, void* out,
              void* partial, int H, int KV, int bs, int MB, int n_blocks, int per,
              float sm_scale) {
  switch (heads) {
#define PA_CASE(N)                                                                  \
  case N:                                                                           \
    if constexpr (N <= LPR)                                                         \
      return split_launch<T, LPR, N>(grid, s, q, k, v, tables, index, out, partial, \
                                     H, KV, bs, MB, n_blocks, per, sm_scale);       \
    break;
    PA_CASE(1) PA_CASE(2) PA_CASE(4) PA_CASE(8)
#undef PA_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_lanes(int lpr, int heads, dim3 grid, cudaStream_t s, const void* q,
              const void* k, const void* v, const void* tables, const void* index,
              void* out, void* partial, int H, int KV, int bs, int MB, int n_blocks,
              int per, float sm_scale) {
  switch (lpr) {
#define PA_CASE(N)                                                              \
  case N:                                                                       \
    return by_heads<T, N>(heads, grid, s, q, k, v, tables, index, out, partial, \
                          H, KV, bs, MB, n_blocks, per, sm_scale);
    PA_CASE(2) PA_CASE(4) PA_CASE(8) PA_CASE(16) PA_CASE(32)
#undef PA_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// partial: (B*H*splits*hd + B*H*splits*2) f32 scratch, unused (may be null)
// when splits == 1. Returns a cudaError_t code.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* index, void* out, void* partial,
                                      int B, int H, int KV, int hd, int bs, int MB,
                                      int n_blocks, int pool_bf16, int splits, int per,
                                      int heads, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = hd * (pool_bf16 ? 2 : 4);
  if (row_bytes % 16 || row_bytes / 16 < heads || H % KV || (H / KV) % heads || splits < 1
      || splits > MAX_SPLITS || per < 1 || (splits - 1) * per >= MB || splits * per < MB || (splits > 1 && !partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpr = row_bytes / 16;          // lanes per K/V row; one head each at most
  const dim3 grid(splits, H / heads, B);
  const cudaError_t e0 = pool_bf16
      ? by_lanes<__nv_bfloat16>(lpr, heads, grid, s, q, k_pool, v_pool, tables, index,
                                out, partial, H, KV, bs, MB, n_blocks, per, sm_scale)
      : by_lanes<float>(lpr, heads, grid, s, q, k_pool, v_pool, tables, index, out,
                        partial, H, KV, bs, MB, n_blocks, per, sm_scale);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  if (splits > 1) {
    const int rows = B * H;
    // programmatic dependent launch: the combine's blocks are scheduled
    // while the split kernel finishes and wait in griddepcontrol.wait
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((rows + WARPS - 1) / WARPS);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const float* part = static_cast<const float*>(partial);
    float* o = static_cast<float*>(out);
    const cudaError_t e =
        hd <= 32    ? cudaLaunchKernelEx(&cfg, paged_attention_combine<1>, part, o, rows, splits, hd)
        : hd <= 64  ? cudaLaunchKernelEx(&cfg, paged_attention_combine<2>, part, o, rows, splits, hd)
        : hd <= 128 ? cudaLaunchKernelEx(&cfg, paged_attention_combine<4>, part, o, rows, splits, hd)
                    : cudaLaunchKernelEx(&cfg, paged_attention_combine<8>, part, o, rows, splits, hd);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
