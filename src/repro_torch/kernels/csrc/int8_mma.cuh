// Building blocks of the int8 tensor-core GEMMs (qgemm.cu and
// qgemm_tile_scales.cu): the shared-memory layout of one 32-deep k stage,
// its asynchronous copy from device memory, the operand fragments of
// mma.sync.m16n8k32 (s8 x s8 -> s32), and the instruction itself.
//
// One stage holds an A tile (BM rows x 32 k, row-major as A is) and a B tile
// (32 k rows x BN columns, row-major as B is: B keeps its public (K, N)
// layout and no repacked copy of it exists). Both are copied 16 bytes at a
// time with cp.async; a ring of stages keeps several in flight.
//
// Operands. The tensor cores want both operands K-major. A row-major A tile
// already is: ldmatrix.x4 hands each lane the words of the A fragment. The
// B fragment wants 4 consecutive k of one column in each 32-bit register,
// and a B tile holds 4 consecutive columns of one k in each word. So a lane
// reads a 4x4 byte block (4 words, k rows 4t..4t+3, columns 4g..4g+3) and
// transposes it in registers with 8 byte permutes. The 4 words it obtains
// are the 4 columns 4g+j, j = 0..3: lane (g, t) takes column 4g+j as column
// g of n-tile j. Relabelling the columns this way costs nothing, and it
// leaves each lane holding 8 consecutive output columns (8t..8t+7) of its
// two rows after the product.
//
// Bank conflicts. A warp's fragment read touches rows 4t+i (t = 0..3) of
// the B tile at 32 consecutive bytes; rows 4 apart would hit the same banks
// whenever a row is a multiple of 32 bytes. The 16-byte chunk index of each
// row is XORed with 2 * ((row / 4) % 4) within its 128-byte line, which
// spreads the four rows over all 32 banks for BN = 32, 64 or 128 and more.
// The A tile's 32-byte rows are swizzled so that the 8 rows of one
// ldmatrix phase fall on 8 different bank groups.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i8mma {

constexpr int KS = 32;  // k depth of one stage, and of one mma.sync

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
// (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of byte `col` (a multiple of 4 when read as a word) of k row
// `r` in a B tile of BN columns.
template <int BN>
__device__ __forceinline__ int b_offset(int r, int col) {
  const int chunk = (r * (BN / 16) + (col >> 4)) ^ (((r >> 2) & 3) << 1);
  return 16 * chunk + (col & 15);
}

// Byte offset of 16-byte chunk c (0 or 1) of row r in an A tile.
__device__ __forceinline__ int a_offset(int r, int c) {
  return 32 * r + 16 * (c ^ ((r >> 2) & 1));
}

// 16 bytes of a row-major int8 matrix (rows x cols), starting at (r, c),
// each byte past the matrix's edge zero: the staging path for operands
// that cp.async cannot take (a row length or a base not 16-byte aligned).
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int rows, int cols, int r,
                                               int c) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (r < rows) {
    const int8_t* row = p + static_cast<size_t>(r) * cols;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < cols)
        w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[c + j])) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage rows [m0, m0 + BM) x k [k0, k0 + 32) of A (M, K) into `as`.
template <int BM, int THREADS, bool VEC>
__device__ __forceinline__ void load_a_stage(int8_t* as, const int8_t* A, int M, int K,
                                             int m0, int k0, int tid) {
#pragma unroll
  for (int q = tid; q < BM * 2; q += THREADS) {
    const int r = q >> 1, c = q & 1;
    const int gm = m0 + r, gk = k0 + 16 * c;
    int8_t* dst = as + a_offset(r, c);
    if constexpr (VEC) {
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? A + static_cast<size_t>(gm) * K + gk : A, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = load16_masked(A, M, K, gm, gk);
    }
  }
}

// Stage k rows [k0, k0 + 32) x columns [n0, n0 + BN) of B (K, N) into `bs`.
template <int BN, int THREADS, bool VEC>
__device__ __forceinline__ void load_b_stage(int8_t* bs, const int8_t* B, int K, int N,
                                             int k0, int n0, int tid) {
  constexpr int CHUNKS = BN / 16;
#pragma unroll
  for (int q = tid; q < KS * CHUNKS; q += THREADS) {
    const int r = q / CHUNKS, c = q % CHUNKS;
    const int gk = k0 + r, gn = n0 + 16 * c;
    int8_t* dst = bs + b_offset<BN>(r, 16 * c);
    if constexpr (VEC) {
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? B + static_cast<size_t>(gk) * N + gn : B, ok);
    } else {
      *reinterpret_cast<uint4*>(dst) = load16_masked(B, K, N, gk, gn);
    }
  }
}

// Transpose a 4x4 byte block: w[i] holds byte c of row i; o[c] gets byte i
// of it from row i.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// B fragments of the 4 n-tiles of the 32 columns [wc, wc + 32) of a staged
// B tile: b[j] = {k 4t..4t+3, k 16+4t..16+4t+3} of column wc + 4g + j.
template <int BN>
__device__ __forceinline__ void load_b_frags(const int8_t* bs, int wc, int lane,
                                             uint32_t (&b)[4][2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(bs + b_offset<BN>(16 * h + 4 * t + i,
                                                                  wc + 4 * g));
    transpose4x4(w, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j][h] = o[j];
  }
}

// A fragment of the 16 rows [rm, rm + 16) of a staged A tile.
__device__ __forceinline__ void load_a_frag(const int8_t* as, int rm, int lane,
                                            uint32_t (&a)[4]) {
  const uint32_t p = smem_addr(as + a_offset(rm + (lane & 15), lane >> 4));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// d += a (16 x 32, s8) @ b (32 x 8, s8), exact in int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 8 values of row g (half 0) or g + 8 (half 1) of an m-tile that lane
// (g, t) holds, in column order 8t .. 8t + 7: n-tile j's two columns are
// 8t + j and 8t + 4 + j.
template <typename T>
__device__ __forceinline__ void row_values(const T (&acc)[4][4], int half, T (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = acc[j][2 * half];
    v[4 + j] = acc[j][2 * half + 1];
  }
}

}  // namespace i8mma
