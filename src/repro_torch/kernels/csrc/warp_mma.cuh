// Warp-level tensor-core pieces shared by K3's f32 forward
// (flash_attention.cu: attention_kernel_f32) and K3's backward
// (flash_attention_bwd.cu): mma.sync products on 16-row tiles, f32 by the
// 3xTF32 split (Tf32x3), their fragments read from shared memory by
// ldmatrix, and the 16-byte cp.async copies that stream tiles into it.
//
// Tiles in shared memory are row-major, rows padded by 16 bytes (tile_ld) so
// that the 8 rows of an ldmatrix phase, or the rows of a column of fragment
// loads, fall in different banks. A warp's fragments, lane = 4 g + t: A is
// 16 rows x kK, B kK x 8; the accumulator of a 16 x 8 tile holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_mma {

// a tile's row stride in elements: its rows padded by 16 bytes
template <int HD, typename T>
__host__ __device__ constexpr int tile_ld() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past `bytes`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of one head of a (batch, seq, heads, HD) tensor
// into a padded tile by 16-byte cp.async copies of THREADS threads; rows
// past `limit` are zero
template <int HD, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int64_t row_stride, int row0, int limit) {
  constexpr int LD = tile_ld<HD, T>();
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = HD / kChunk;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk, s = row0 + r;
    const bool in = s < limit;
    cp_async16(dst + r * LD + c, src + (in ? s * row_stride + c : 0), in ? 16 : 0);
  }
}

__device__ __forceinline__ bool is_valid(int kpos, int qpos, int sk, int causal, int window) {
  bool ok = kpos < sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// does the block of pairs (keys [k_first, k_first + KEYS), query positions
// [q_first, q_first + 16)) hold a valid one?
template <int KEYS = 16>
__device__ __forceinline__ bool any_valid(int k_first, int q_first, int sk, int causal,
                                          int window) {
  bool ok = k_first < sk;
  if (causal) ok = ok && k_first <= q_first + 15;
  if (window > 0) ok = ok && k_first + KEYS - 1 > q_first - window;
  return ok;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 16-byte matrices of shared memory into a warp's registers:
// register j of lane 4 g + t holds 4 bytes at (row g, byte 4 t) of matrix
// j, whose row addresses lanes 8 j to 8 j + 7 give
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(row)));
}

// the row a lane addresses for ldsm_x4 in a 16-row tile of stride LD
// elements, E elements to 16 bytes: an A fragment's matrices are (rows 0-7,
// bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31); two B fragments'
// (rows 0-7 and 8-15 being the two n-tiles) (0-7, 0-15), (0-7, 16-31),
// (8-15, 0-15), (8-15, 16-31)
template <int LD, int E>
__device__ __forceinline__ int a_row(int lane) {
  return (lane % 8 + 8 * (lane / 8 % 2)) * LD + E * (lane / 16);
}
template <int LD, int E>
__device__ __forceinline__ int b2_row(int lane) {
  return (lane % 8 + 8 * (lane / 16)) * LD + E * (lane / 8 % 2);
}

// The f32 policy. load_a reads A from [row][k], load_b2_nk the B fragments
// of two n-tiles from [n][k] (K-major), both by ldmatrix; load_b_kn reads B
// from [k][n] (MN-major); a_from_acc takes k-chunk j of a 16 x N
// accumulator as an A fragment. Products run m16n8k8 TF32 on the 3xTF32
// split of CUTLASS's OpMultiplyAddFastF32: each operand x is split into big
// = x rounded to TF32 and small = x - big rounded likewise, and the
// accumulator takes small*big + big*small + big*big, smallest first.
struct Tf32x3 {
  using T = float;
  static constexpr int kK = 8;
  static constexpr bool kSplit = true;   // a streamed tile used twice is split once, by split_tile
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };

  // big = x rounded to TF32 (10 explicit mantissa bits, to nearest, ties
  // away: cvt.rna.tf32.f32's rounding, in two integer operations); small =
  // x - big, exact in f32, rounded the same way by adding half a TF32 ulp:
  // the mma reads a TF32 operand's top 19 bits and drops the rest
  static __device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
  }
  template <int LD>
  static __device__ __forceinline__ A load_a(const float* p, int lane) {
    uint32_t r[4];
    ldsm_x4(r, p + a_row<LD, 4>(lane));
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), a.big[i], a.small[i]);
    return a;
  }
  // A already split (split_tile): big halves at p, small ones at `small`
  template <int LD>
  static __device__ __forceinline__ A load_a(const float* p, const float* small, int lane) {
    A a;
    ldsm_x4(a.big, p + a_row<LD, 4>(lane));
    ldsm_x4(a.small, small + a_row<LD, 4>(lane));
    return a;
  }
  // PRE: p holds big halves and `small` the small ones (split_tile); else p
  // holds f32 values, split here
  template <int LD, bool PRE>
  static __device__ __forceinline__ void load_b2_nk(B (&b)[2], const float* p, const float* small,
                                                    int lane) {
    uint32_t r[4];
    ldsm_x4(r, p + b2_row<LD, 4>(lane));
    if constexpr (PRE) {
      uint32_t lo[4];
      ldsm_x4(lo, small + b2_row<LD, 4>(lane));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i / 2].big[i % 2] = r[i];
        b[i / 2].small[i % 2] = lo[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(__uint_as_float(r[i]), b[i / 2].big[i % 2], b[i / 2].small[i % 2]);
    }
  }
  // k = t and t + 4 are rows 2t and 2t + 1: the order a_from_acc gives
  template <int LD, bool PRE>
  static __device__ __forceinline__ B load_b_kn(const float* p, const float* small, int g, int t) {
    B b;
    if constexpr (PRE) {
      b.big[0] = __float_as_uint(p[2 * t * LD + g]);
      b.small[0] = __float_as_uint(small[2 * t * LD + g]);
      b.big[1] = __float_as_uint(p[(2 * t + 1) * LD + g]);
      b.small[1] = __float_as_uint(small[(2 * t + 1) * LD + g]);
    } else {
      split(p[2 * t * LD + g], b.big[0], b.small[0]);
      split(p[(2 * t + 1) * LD + g], b.big[1], b.small[1]);
    }
    return b;
  }
  // P and dS stay in registers: the m16n8 accumulator holds columns 2t and
  // 2t + 1 where the tf32 A fragment wants t and t + 4, so the contraction
  // index of the next product is permuted (load_b_kn reads B's rows 2t and
  // 2t + 1 to match)
  template <int NT>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[NT][4], int j) {
    A a;
    split(c[j][0], a.big[0], a.small[0]);   // (g, k = t) is column 2t
    split(c[j][2], a.big[1], a.small[1]);   // (g + 8, t)
    split(c[j][1], a.big[2], a.small[2]);   // (g, t + 4) is column 2t + 1
    split(c[j][3], a.big[3], a.small[3]);   // (g + 8, t + 4)
    return a;
  }
  // SWAP: the terms in the order of the transposed product, so that S^T of
  // dkv_kernel (K as A, Q as B) is S of dq_kernel (Q as A, K as B) bit for bit
  template <bool SWAP = false>
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    if constexpr (SWAP) {
      mma_tf32(d, a.big, b.small);
      mma_tf32(d, a.small, b.big);
    } else {
      mma_tf32(d, a.small, b.big);
      mma_tf32(d, a.big, b.small);
    }
    mma_tf32(d, a.big, b.big);
  }
};

// The tensor cores add into their f32 accumulator with truncation, not
// rounding, so the error of a chain of mma.sync on one accumulator grows with
// its length: a 128-long f32 dot product is 48 TF32 products. Each chain of
// at most kChain k-steps starts from zero instead and is added to the running
// sum by an f32 add, which rounds.
constexpr int kChain = 2;

// acc (16 x HD) += p (16 x 8 NK, registers) . z (8 NK rows x HD), in chains
// of at most kChain k-steps
template <class P, int HD, int LD, bool PRE, int NK>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4], const float (&p)[NK][4],
                                           const typename P::T* z,
                                           const typename P::T* z_small, int g, int t) {
  constexpr int kSteps = NK * 8 / P::kK;
  constexpr int kC = kSteps < kChain ? kSteps : kChain;
#pragma unroll
  for (int j0 = 0; j0 < kSteps; j0 += kC) {
    typename P::A fa[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) fa[c] = P::a_from_acc(p, j0 + c);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = j0 + c;
        P::mma(part, fa[c], P::template load_b_kn<LD, PRE>(z + j * P::kK * LD + nt * 8,
                                                            z_small + j * P::kK * LD + nt * 8,
                                                            g, t));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
    }
  }
}

// a landed tile of ROWS rows that several warps read, split once by the
// block's THREADS threads (P::kSplit): each element x becomes big in place,
// and its small half goes to the same place in `small`
template <int HD, class P, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* small) {
  constexpr int LD = tile_ld<HD, float>(), kPerRow = HD / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int at = i / kPerRow * LD + i % kPerRow * 4;
    const float4 v = *reinterpret_cast<const float4*>(tile + at);
    uint4 big, lo;
    P::split(v.x, big.x, lo.x);
    P::split(v.y, big.y, lo.y);
    P::split(v.z, big.z, lo.z);
    P::split(v.w, big.w, lo.w);
    *reinterpret_cast<uint4*>(tile + at) = big;
    *reinterpret_cast<uint4*>(small + at) = lo;
  }
}

}  // namespace warp_mma
