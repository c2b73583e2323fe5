// Block-native paged decode attention over the KV block pool.
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
// Bound on this card: each decode step reads every valid K/V cell of every
// slot once and does ~4*H*hd operations per position, so it is bound by the
// pool bytes it reads (3.35 TB/s).
//
// Design (simple first): one block per (slot, KV head), so the rep query
// heads of a group share every K/V tile load. A loop over the slot's table
// entries takes the place of the TPU's sequential grid axis; the block loads
// its own table entries (no scalar prefetch). Each step stages one pool
// block's K and V tile for head g in shared memory as f32, scores the rep
// heads against it, and folds it into an online softmax (running max m,
// normaliser l, unnormalised output acc) in f32. The loop stops after the
// block that holds position min(index[b], S - 1): later table entries are
// wholly masked and would add exactly 0, so they are not read at all. An idle
// slot's index can run past S; its loop still ends at the last table entry,
// and table entries are clamped to the pool, so no read leaves the pool.
// Not yet: a split over the block axis (flash-decoding) to fill all SMs when
// slots x KV heads is small, vector loads, and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_floats(int rep, int hd, int bs) {
  // q, acc: rep*hd each; K tile padded to hd+1 per row (no bank conflicts
  // when 16 threads read one column); V tile; scores; m, l, corr.
  return 2 * static_cast<size_t>(rep) * hd + static_cast<size_t>(bs) * (hd + 1)
         + static_cast<size_t>(bs) * hd + static_cast<size_t>(rep) * bs + 3 * rep;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ index, float* __restrict__ out,
                       int H, int KV, int hd, int bs, int MB, int n_blocks,
                       float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int rep = H / KV;
  const int kst = hd + 1;
  float* q_s = smem;
  float* acc_s = q_s + rep * hd;
  float* k_s = acc_s + rep * hd;
  float* v_s = k_s + bs * kst;
  float* p_s = v_s + bs * hd;
  float* m_s = p_s + rep * bs;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;

  const int idx = index[b];
  const float* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * hd;
  for (int i = tid; i < rep * hd; i += THREADS) {
    q_s[i] = qb[i];
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int S = MB * bs;
  const int last = idx < S - 1 ? idx : S - 1;
  const int n_tbl = idx < 0 ? 0 : last / bs + 1;

  for (int j = 0; j < n_tbl; ++j) {
    int blk = tables[static_cast<size_t>(b) * MB + j];
    blk = min(max(blk, 0), n_blocks - 1);
    __syncthreads();  // the previous step is done with k_s, v_s, p_s
    for (int i = tid; i < bs * hd; i += THREADS) {
      const int t = i / hd, d = i - t * hd;
      const size_t off = ((static_cast<size_t>(blk) * bs + t) * KV + g) * hd + d;
      k_s[t * kst + d] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < rep * bs; i += THREADS) {
      const int r = i / bs, t = i - r * bs;
      const float* qr = q_s + r * hd;
      const float* kt = k_s + t * kst;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kt[d], s);
      p_s[i] = (j * bs + t <= idx) ? s * sm_scale : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < rep; r += THREADS) {
      float* pr = p_s + r * bs;
      const float m_prev = m_s[r];
      float mx = NEG_INF;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, pr[t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        // explicit zero: a masked position adds nothing even while m is
        // still NEG_INF
        const float p = (j * bs + t <= idx) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = p_s + r * bs;
      float a = acc_s[i] * c_s[r];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  float* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * hd;
  for (int i = tid; i < rep * hd; i += THREADS) ob[i] = acc_s[i] / l_s[i / hd];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* index, void* out, int B, int H, int KV, int hd, int bs,
           int MB, int n_blocks, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, hd, bs) * sizeof(float);
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, KV);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(index), static_cast<float*>(out), H, KV, hd, bs,
      MB, n_blocks, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* index, void* out, int B, int H,
                                      int KV, int hd, int bs, int MB,
                                      int n_blocks, int pool_bf16,
                                      float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, index, out, B, H,
                                 KV, hd, bs, MB, n_blocks, sm_scale, s);
  return launch<float>(q, k_pool, v_pool, tables, index, out, B, H, KV, hd, bs,
                       MB, n_blocks, sm_scale, s);
}
