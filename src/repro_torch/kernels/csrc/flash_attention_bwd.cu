// The gradient of K3: dq, dk and dv of causal GQA flash attention with an
// optional sliding window, for Hopper (sm_90a), on the tensor cores.
//
// Replaces what the TPU path gets from autodiff: the JAX package has no
// backward Pallas kernel, and differentiates src/repro/models/layers.py:154
// (mea_attention; jax.checkpoint per query chunk, so the backward recomputes
// each chunk's scores) through XLA. Here the function K3 computes
// (src/repro_torch/kernels/csrc/flash_attention.cu, whose TPU kernel is
// src/repro/kernels/flash_attention.py:flash_attention) is differentiated by
// hand. With s = q k^T * scale masked where kpos >= Sk, kpos > qpos (causal)
// or kpos <= qpos - window, and lse K3's log-sum-exp of s over the valid keys
// of each row (+inf on a row with none):
//
//   P_ij  = exp(s_ij - lse_i) / sum_j exp(s_ij - lse_i)   (0 where masked)
//   D_i   = rowsum(dO_i * O_i)
//   dV_j  = sum_i P_ij dO_i                       (over the group's heads)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_i dS_ij q_i               (over the group's heads)
//
// Bound on the H100 by route, at the training shape (B 16, S 128, H 40, KV 8,
// hd 128, causal, f32): the five products a valid (query, key) pair needs
// (S, dP, dV, dK, dQ) are 6.76e9 flops; 3 TF32 products each at 495 TFLOP/s
// is an effective 165 TFLOP/s, 0.041 ms, against 201 MB of q, k, v, o, dO,
// lse and the three gradients, 0.060 ms at 3.35 TB/s: 0.060 ms, bound by
// bytes (on the f32 CUDA cores, 0.101 ms, by operations). The design, point
// by point:
//
// 1. Tensor cores. Every product is a warp's mma.sync over 16-row tiles.
//    f32 runs m16n8k8 TF32 products on the 3xTF32 split of CUTLASS's
//    OpMultiplyAddFastF32: each operand x is split into big = x rounded to
//    TF32 (cvt.rna.tf32's rounding, in integer operations) and small = x -
//    big rounded likewise, and the accumulator takes small*big + big*small +
//    big*big, smallest first (Tf32x3, in warp_mma.cuh, which K3's f32
//    forward shares with the cp.async and tile helpers). The tensor cores
//    truncate as they accumulate, so every kChain k-steps start from a zero
//    accumulator that an f32 add, which rounds, folds into the sum. bf16
//    runs m16n8k16 bf16 products, P and dS rounded to bf16 as operands
//    (Bf16), as FlashAttention-2 does. wgmma is not used: it takes tf32
//    only with both operands K-major, and three of the five products
//    contract over rows stored MN-major. dkv_kernel forms S^T = K Q^T with
//    the terms of each product in dq_kernel's order for Q K^T, so that its
//    scores are dq's bit for bit.
//    P and dS stay in registers: the m16n8 accumulator holds columns 2t and
//    2t + 1 where the tf32 A fragment wants t and t + 4, so the contraction
//    index of the next product is permuted (A's k = t, t + 4 read columns 2t,
//    2t + 1, and load_b_kn reads B's rows 2t, 2t + 1 to match). bf16's A
//    fragment is the accumulator pair by pair (FlashAttention-2's layout).
//    A fragments and K-major B fragments come by ldmatrix.x4.
// 2. Occupancy. A block is 4 warps; each warp owns 16 rows of the block's 64
//    resident rows. Shared memory per block: 64 resident rows of two tensors,
//    a two-stage ring of 16 streamed rows of two tensors and, in f32, the
//    small halves of the streamed tile that two products read (split once by
//    split_tile for the 4 warps: K in dq_kernel, Q in dkv_kernel), rows
//    padded by 16 bytes against bank conflicts: 110,080 B for dQ and
//    110,208 B for dK/dV at hd 128 in f32 (52,480 B and 65,536 B in bf16),
//    so two blocks (8 warps) share an SM. Registers: ptxas -v, printed by the build
//    (kernels/_build.py); at hd 128 both f32 kernels are at or near 255.
// 3. Loads. Tiles arrive by 16-byte cp.async copies into the ring; the next
//    tile's copies are in flight while the current tile's products run.
//    Rows past Sq or Sk are zero-filled by cp.async's source size. D comes
//    from dO in shared memory and O by 16-byte loads.
// 4. Seven products a pair. K3's forward writes lse (its optional lse
//    pointer), so no statistics walk is needed. dq_kernel, one block per
//    (64 query rows, head, batch), writes D once per row for dkv_kernel, then
//    streams key tiles: S, dP, dQ (3 products). dkv_kernel, one block per
//    (64 keys, KV head, batch, share of the group), streams query tiles: S^T,
//    dP^T, dV, dK (4 products). P = exp2(s * scale * log2(e) - lse * log2(e))
//    sums to 1 over a row only where these scores are the forward's to the
//    bit, and with logits far from 0 a score's last bits move P by more than
//    f32 holds: dq_kernel also sums each row's P as it goes, divides dQ by
//    the sum (dQ is linear in P, D held) and hands 1 / sum to dkv_kernel
//    with D, so that both take P as the softmax of the scores they compute.
// 5. The GQA group without atomics. dkv_kernel's blocks of one (key tile, KV
//    head, batch) form a thread-block cluster of up to 8, one share of the
//    group's query heads each (groups above 8 loop inside a block). Each
//    block leaves its partial dK and dV in its shared memory; after a cluster
//    barrier each block sums a slice of them over the cluster's blocks in
//    rank order through distributed shared memory and writes it. Nothing is
//    added atomically: the same bits every run. Key tiles are numbered
//    heaviest first (the causal first tile sees every query), query tiles of
//    dq_kernel likewise (the last sees every key).
//
// What holds it back at the training shape: 3 TF32 products and the
// operands' splits per f32 product, and 2 warps per SM sub-partition (254
// registers, 110 KB of shared memory a block) to hide the latency of each
// warp's chain of fragment loads, splits and mma.sync.
//
// A row with no valid key has lse = +inf and P = 0: no gradient flows through
// it. A warp skips a 16 x 16 step none of whose pairs is valid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "introspect.cuh"
#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int kRows = 64;      // resident rows a block keeps: query rows or keys
constexpr int kStream = 16;    // rows per streamed tile
constexpr int kStages = 2;     // depth of the streamed ring
constexpr int kThreads = 128;  // 4 warps, 16 resident rows each
constexpr int kMaxCluster = 8;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory per block, in bytes: two resident tiles of kRows rows, the
// ring of two streamed tiles of kStream rows, and for a policy that splits
// its operands (P::kSplit) the small halves of one streamed tile; then the
// row scalars (dq_kernel: D; dkv_kernel: lse, D and 1 / sum P per streamed
// row), or dkv_kernel's f32 partial dK and dV where they take more
template <int HD, class P>
struct Smem {
  static constexpr int kLD = tile_ld<HD, typename P::T>();
  static constexpr int kTiles = (2 * kRows + 2 * kStages * kStream + (P::kSplit ? kStream : 0)) *
                                kLD * sizeof(typename P::T);
  static constexpr int kDq = kTiles + kRows * 4;                          // + D
  static constexpr int kDkvTiles = kTiles + 3 * kStages * kStream * 4;    // + lse, (D, 1 / sum P)
  static constexpr int kPartials = 2 * kRows * HD * 4;                    // dK, dV in f32
  static constexpr int kDkv = kDkvTiles > kPartials ? kDkvTiles : kPartials;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 bytes of block `rank`'s shared memory at the address `p` has in this one
__device__ __forceinline__ float4 ld_cluster(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// the dot product of 16 bytes at p (global) and q (shared), in f32
__device__ __forceinline__ float dot16(const float* p, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(q);
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* p, const __nv_bfloat16* q) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(q);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.y, w.y, fmaf(u.x, w.x, acc));
  }
  return acc;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// the two products, f32 by 3xTF32 and bf16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr bool kSplit = false;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  static __device__ __forceinline__ uint32_t pack(T lo, T hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <int LD>
  static __device__ __forceinline__ A load_a(const T* p, int lane) {
    A a;
    ldsm_x4(a.x, p + a_row<LD, 8>(lane));
    return a;
  }
  template <int LD, bool PRE>
  static __device__ __forceinline__ void load_b2_nk(B (&b)[2], const T* p, const T*, int lane) {
    uint32_t r[4];
    ldsm_x4(r, p + b2_row<LD, 8>(lane));
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i / 2].x[i % 2] = r[i];
  }
  template <int LD, bool PRE>
  static __device__ __forceinline__ B load_b_kn(const T* p, const T*, int g, int t) {
    B b;
    b.x[0] = pack(p[2 * t * LD + g], p[(2 * t + 1) * LD + g]);
    b.x[1] = pack(p[(2 * t + 8) * LD + g], p[(2 * t + 9) * LD + g]);
    return b;
  }
  template <int NT>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[NT][4], int j) {
    A a;
    a.x[0] = pack(c[2 * j][0], c[2 * j][1]);
    a.x[1] = pack(c[2 * j][2], c[2 * j][3]);
    a.x[2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
    a.x[3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
    return a;
  }
  template <bool SWAP = false>
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.x, b.x);
  }
};

// s (16 x kStream) = a (16 rows) . b (kStream rows)^T over HD; SWAP: each
// term in the order of b . a^T
static_assert(kStream == 16, "load_b2_nk reads the two n-tiles of a 16-row streamed tile");
template <class P, int HD, int LD, bool PRE, bool SWAP = false>
__device__ __forceinline__ void scores(float (&s)[2][4], const typename P::T* a,
                                       const typename P::T* b, const typename P::T* b_small,
                                       int lane) {
  constexpr int kSteps = HD / P::kK, kC = kSteps < kChain ? kSteps : kChain;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += kC * P::kK) {
    // Each n-tile loads its own B, so one chain step's B is live at a time
    // (twice the ldmatrix): with every chain's B fragments live, the 3xTF32
    // dK/dV kernel at hd 128 sat at the 255-register cap and spilled (the
    // kernel audit, src/repro_torch/analysis/kernel_audit.py). At hd 32 and
    // in bf16 it times as the chained loads did, at hd 64 in f32 ~1% slower
    // on the mean (about either's spread), with the same gradients bit for
    // bit (tools/attention_bwd_times.py on an "NVIDIA H100 80GB HBM3,
    // 700.00 W").
    typename P::A fa[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) fa[c] = P::template load_a<LD>(a + kk + c * P::kK, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        typename P::B fb[2];
        P::template load_b2_nk<LD, PRE>(fb, b + kk + c * P::kK, b_small + kk + c * P::kK, lane);
        P::template mma<SWAP>(part, fa[c], fb[nt]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += part[e];
    }
  }
}

// ---------------------------------------------------------------------------
// D and dQ
// ---------------------------------------------------------------------------

template <int HD, class P>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
          const typename P::T* __restrict__ v, const typename P::T* __restrict__ o,
          const typename P::T* __restrict__ dout, const float* __restrict__ lse,
          typename P::T* __restrict__ dq, float2* __restrict__ dsum, int sq, int sk, int h,
          int kvh, float scale, int causal, int window, int q_offset) {
  using T = typename P::T;
  constexpr int LD = tile_ld<HD, T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);     // kRows x LD
  T* dos = qs + kRows * LD;                   // kRows x LD
  T* ks = dos + kRows * LD;                   // kStages x kStream x LD
  T* vs = ks + kStages * kStream * LD;        // kStages x kStream x LD
  T* k_small = vs + kStages * kStream * LD;   // kStream x LD, when P::kSplit
  float* d_s = reinterpret_cast<float*>(k_small + (P::kSplit ? kStream * LD : 0));  // kRows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // the longest causal walk first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = static_cast<int64_t>(h) * HD;
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const int64_t q_base = (static_cast<int64_t>(b) * sq * h + head) * HD;
  const int64_t k_base = (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;
  const int64_t r_base = (static_cast<int64_t>(b) * h + head) * sq;   // lse and D rows

  load_rows<HD, kRows, kThreads>(qs, q + q_base, q_row, q0, sq);
  load_rows<HD, kRows, kThreads>(dos, dout + q_base, q_row, q0, sq);
  cp_async_commit();

  // the key tiles between the window's lower edge and the causal diagonal
  const int nk = (sk + kStream - 1) / kStream;
  int kt_end = nk;
  if (causal) {
    const int last = q_offset + min(q0 + kRows, sq) - 1;
    kt_end = last < 0 ? 0 : min(nk, last / kStream + 1);
  }
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    kt_begin = lo > 0 ? lo / kStream : 0;
  }
  const int n = max(kt_end - kt_begin, 0);
  auto fetch = [&](int i) {
    const int st = i % kStages, k0 = (kt_begin + i) * kStream;
    load_rows<HD, kStream, kThreads>(ks + st * kStream * LD, k + k_base, k_row, k0, sk);
    load_rows<HD, kStream, kThreads>(vs + st * kStream * LD, v + k_base, k_row, k0, sk);
  };
  if (n > 0) fetch(0);
  cp_async_commit();

  // D = rowsum(dO * O) of this warp's 16 rows, written once for dkv_kernel:
  // dO from shared memory, O by 16-byte loads, a row over kC lanes
  cp_async_wait<1>();   // Q and dO have landed (key tile 0 may be in flight)
  __syncthreads();
  const int r0 = warp * 16;   // this warp's rows of the block's
  {
    constexpr int kE = 16 / sizeof(T), kC = HD / kE, kR = 32 / kC;
#pragma unroll
    for (int r = lane / kC; r < 16; r += kR) {
      const int row = q0 + r0 + r;
      float acc = 0.f;
      if (row < sq) acc = dot16(o + q_base + row * q_row + (lane % kC) * kE,
                                dos + (r0 + r) * LD + (lane % kC) * kE);
#pragma unroll
      for (int off = kC / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane % kC == 0) {
        d_s[r0 + r] = acc;
        if (row < sq) dsum[r_base + row].x = acc;
      }
    }
  }
  __syncwarp();

  // this thread's rows: r0 + g and r0 + g + 8
  const float scale2 = scale * kLog2e;
  const float dd[2] = {d_s[r0 + g], d_s[r0 + g + 8]};
  float lse2[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    qpos[i] = q_offset + row;
    lse2[i] = row < sq ? lse[r_base + row] * kLog2e : INFINITY;   // P = 0 past Sq
  }
  const int q_first = q_offset + q0 + r0;
  float psum[2] = {0.f, 0.f};   // this thread's share of sum_j P_ij of its two rows

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages, k0 = (kt_begin + i) * kStream;
    if (i + 1 < n) fetch(i + 1);   // its stage was last read before the previous barrier
    cp_async_commit();
    cp_async_wait<1>();            // tile i has landed
    __syncthreads();
    T* kt = ks + st * kStream * LD;
    if constexpr (P::kSplit) {   // K feeds S and dQ
      split_tile<HD, P, kStream, kThreads>(kt, k_small);
      __syncthreads();
    }
    if (q0 + r0 < sq && any_valid(k0, q_first, sk, causal, window)) {
      float s[kStream / 8][4], dp[kStream / 8][4];
      scores<P, HD, LD, P::kSplit>(s, qs + r0 * LD, kt, k_small, lane);
      scores<P, HD, LD, false>(dp, dos + r0 * LD, vs + st * kStream * LD, k_small, lane);
#pragma unroll
      for (int nt = 0; nt < kStream / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e / 2;
          const bool ok = is_valid(k0 + nt * 8 + 2 * t + (e & 1), qpos[ri], sk, causal, window);
          const float p = ok ? exp2f(fmaf(s[nt][e], scale2, -lse2[ri])) : 0.f;
          psum[ri] += p;
          s[nt][e] = p * (dp[nt][e] - dd[ri]);   // dS
        }
      accumulate<P, HD, LD, P::kSplit>(acc, s, kt, k_small, g, t);
    }
    __syncthreads();   // every warp is done with stage st
  }
  cp_async_wait<0>();  // no copy may land after the block has left

  // exp(s - lse) sums to 1 over a row only where these scores are the
  // forward's to the bit; divided by its sum, P is the softmax of these
  // scores. dQ is linear in P (D held), so the division comes last, and
  // dkv_kernel, whose scores are these bit for bit, takes the same factor
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 1);
    psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 2);
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = q0 + r0 + g + 8 * ri;
    if (row >= sq) continue;
    const float inv = psum[ri] > 0.f ? 1.f / psum[ri] : 0.f;   // 0 on a row with no valid key
    if (t == 0) dsum[r_base + row].y = inv;
    const float f = scale * inv;
    T* out = dq + q_base + row * q_row + 2 * t;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      store2(out + nt * 8, acc[nt][2 * ri] * f, acc[nt][2 * ri + 1] * f);
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

template <int HD, class P>
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
           const typename P::T* __restrict__ v, const typename P::T* __restrict__ dout,
           const float* __restrict__ lse, const float2* __restrict__ dsum,
           typename P::T* __restrict__ dk, typename P::T* __restrict__ dv, int sq, int sk,
           int h, int kvh, float scale, int causal, int window, int q_offset) {
  using T = typename P::T;
  constexpr int LD = tile_ld<HD, T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);     // kRows x LD
  T* vs = ks + kRows * LD;                    // kRows x LD
  T* qs = vs + kRows * LD;                    // kStages x kStream x LD
  T* dos = qs + kStages * kStream * LD;       // kStages x kStream x LD
  T* q_small = dos + kStages * kStream * LD;  // kStream x LD, when P::kSplit
  float* lse_s = reinterpret_cast<float*>(q_small + (P::kSplit ? kStream * LD : 0));
  float2* d_s = reinterpret_cast<float2*>(lse_s + kStages * kStream);    // kStages x kStream

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rank = static_cast<int>(cluster_rank()), n_ranks = static_cast<int>(cluster_size());
  const int k0 = (blockIdx.x / n_ranks) * kRows;   // key tile 0 (the heaviest) first
  const int kv_head = blockIdx.y, b = blockIdx.z;
  const int groups = h / kvh, per_block = groups / n_ranks;
  const int64_t q_row = static_cast<int64_t>(h) * HD;
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const int64_t k_base = (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;

  load_rows<HD, kRows, kThreads>(ks, k + k_base, k_row, k0, sk);
  load_rows<HD, kRows, kThreads>(vs, v + k_base, k_row, k0, sk);
  cp_async_commit();

  // the query tiles that can see a key of this tile
  const int nq = (sq + kStream - 1) / kStream;
  int qt_begin = 0;
  if (causal) qt_begin = max(k0 - q_offset, 0) / kStream;
  int qt_end = nq;
  if (window > 0) {
    const int last = min(k0 + kRows, sk) - 1 + window - 1 - q_offset;
    qt_end = last < 0 ? 0 : min(nq, last / kStream + 1);
  }
  const int n_qt = max(qt_end - qt_begin, 0);
  const int steps = per_block * n_qt;
  // step j: query head rank + (j / n_qt) * n_ranks of the group, query tile
  // qt_begin + j % n_qt
  auto step_head = [&](int j) { return kv_head * groups + rank + (j / n_qt) * n_ranks; };
  auto step_q0 = [&](int j) { return (qt_begin + j % n_qt) * kStream; };
  auto fetch = [&](int j) {
    const int st = j % kStages, head = step_head(j), q0 = step_q0(j);
    const int64_t q_base = (static_cast<int64_t>(b) * sq * h + head) * HD;
    const int64_t r_base = (static_cast<int64_t>(b) * h + head) * sq;
    load_rows<HD, kStream, kThreads>(qs + st * kStream * LD, q + q_base, q_row, q0, sq);
    load_rows<HD, kStream, kThreads>(dos + st * kStream * LD, dout + q_base, q_row, q0, sq);
    if (tid < kStream) {
      const int row = q0 + tid;
      const bool in = row < sq;
      cp_async4(lse_s + st * kStream + tid, lse + (in ? r_base + row : 0), in ? 4 : 0);
    } else if (tid < 2 * kStream) {
      const int r = tid - kStream, row = q0 + r;
      const bool in = row < sq;
      cp_async8(d_s + st * kStream + r, dsum + (in ? r_base + row : 0), in ? 8 : 0);
    }
  };
  if (steps > 0) fetch(0);
  cp_async_commit();

  const int r0 = warp * 16;   // this warp's keys: k0 + r0 + [0, 16)
  const float scale2 = scale * kLog2e;
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    const int st = j % kStages, q0 = step_q0(j);
    if (j + 1 < steps) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and step j's tiles have landed
    __syncthreads();
    T* qt = qs + st * kStream * LD;
    const T* dot = dos + st * kStream * LD;
    if constexpr (P::kSplit) {   // Q feeds S^T and dK
      split_tile<HD, P, kStream, kThreads>(qt, q_small);
      __syncthreads();
    }
    if (any_valid(k0 + r0, q_offset + q0, sk, causal, window)) {
      const float* lrow = lse_s + st * kStream;
      const float2* drow = d_s + st * kStream;   // D and 1 / sum_j P_ij of each query row
      // S^T and dP^T: [key][query]
      float s[kStream / 8][4], dp[kStream / 8][4];
      scores<P, HD, LD, P::kSplit, true>(s, ks + r0 * LD, qt, q_small, lane);
      scores<P, HD, LD, false, true>(dp, vs + r0 * LD, dot, q_small, lane);
#pragma unroll
      for (int nt = 0; nt < kStream / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1), qrow = q0 + col;
          const int kpos = k0 + r0 + g + 8 * (e / 2);
          const bool ok = qrow < sq && is_valid(kpos, q_offset + qrow, sk, causal, window);
          const float p =
              ok ? exp2f(fmaf(s[nt][e], scale2, -lrow[col] * kLog2e)) * drow[col].y : 0.f;
          s[nt][e] = p;                                 // P^T
          dp[nt][e] = p * (dp[nt][e] - drow[col].x);    // dS^T
        }
      accumulate<P, HD, LD, false>(dv_acc, s, dot, q_small, g, t);
      accumulate<P, HD, LD, P::kSplit>(dk_acc, dp, qt, q_small, g, t);
    }
    __syncthreads();   // every warp is done with stage st
  }
  cp_async_wait<0>();  // K and V have landed even when no step ran
  __syncthreads();

  // this block's partial dK and dV, f32, [key][d], in its shared memory
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + g + 8 * ri;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + row * HD + col) =
          make_float2(dk_acc[nt][2 * ri], dk_acc[nt][2 * ri + 1]);
      *reinterpret_cast<float2*>(part + (kRows + row) * HD + col) =
          make_float2(dv_acc[nt][2 * ri], dv_acc[nt][2 * ri + 1]);
    }
  }
  cluster_sync();   // every block's partials are in place
  // each block sums a slice over the cluster's blocks, in rank order
  constexpr int kVecs = 2 * kRows * HD / 4;
  for (int i = rank * kThreads + tid; i < kVecs; i += n_ranks * kThreads) {
    float4 sum = ld_cluster(part + 4 * i, 0);
    for (int r = 1; r < n_ranks; ++r) {
      const float4 x = ld_cluster(part + 4 * i, r);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int flat = 4 * i, which = flat / (kRows * HD), rem = flat % (kRows * HD);
    const int row = rem / HD, col = rem % HD;
    if (k0 + row >= sk) continue;
    const float f = which == 0 ? scale : 1.f;
    sum.x *= f;
    sum.y *= f;
    sum.z *= f;
    sum.w *= f;
    store4((which == 0 ? dk : dv) + k_base + (k0 + row) * k_row + col, sum);
  }
  cluster_sync();   // no block leaves while another reads its partials
}

template <int HD, class P>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* dsum, int b, int sq, int sk,
           int h, int kvh, float scale, int causal, int window, int q_offset, int cluster,
           cudaStream_t stream) {
  using T = typename P::T;
  if (cluster < 1 || cluster > kMaxCluster || (h / kvh) % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float2* dp = static_cast<float2*>(dsum);
  constexpr int dq_bytes = Smem<HD, P>::kDq;
  constexpr int dkv_bytes = Smem<HD, P>::kDkv;
  // a block may take 232,448 B; two share an SM's 233,472 B (1 KB reserved each)
  static_assert(dq_bytes <= 232448 && dkv_bytes <= 232448, "shared memory per block");
  static_assert(2 * (dq_bytes + 1024) <= 233472 && 2 * (dkv_bytes + 1024) <= 233472,
                "two blocks to an SM");
  auto k_dq = dq_kernel<HD, P>;
  auto k_dkv = dkv_kernel<HD, P>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(k_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sq + kRows - 1) / kRows, h, b);
  k_dq<<<grid_q, kThreads, dq_bytes, stream>>>(qp, kp, vp, static_cast<const T*>(o), dop, lp,
                                               static_cast<T*>(dq), dp, sq, sk, h, kvh, scale,
                                               causal, window, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((sk + kRows - 1) / kRows) * cluster, kvh, b);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dkv_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k_dkv, qp, kp, vp, dop, lp, static_cast<const float2*>(dp),
                           static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, kvh, scale,
                           causal, window, q_offset);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                       const void*, void*, void*, void*, void*, int, int, int, int, int,
                       float, int, int, int, int, cudaStream_t);

// the dQ (dkv false) or dK/dV kernel at its launch configuration; cluster:
// the dK/dV launch's cluster size, for its resident clusters
template <int HD, class P>
int query_instance(bool dkv, int cluster, int* out, const char** name) {
  if (dkv)
    return introspect::query(reinterpret_cast<const void*>(dkv_kernel<HD, P>), kThreads,
                             Smem<HD, P>::kDkv, cluster, out, name);
  return introspect::query(reinterpret_cast<const void*>(dq_kernel<HD, P>), kThreads,
                           Smem<HD, P>::kDq, 1, out, name);
}

template <class P>
int query_hd(int hd, bool dkv, int cluster, int* out, const char** name) {
  switch (hd) {
    case 16: return query_instance<16, P>(dkv, cluster, out, name);
    case 32: return query_instance<32, P>(dkv, cluster, out, name);
    case 64: return query_instance<64, P>(dkv, cluster, out, name);
    case 128: return query_instance<128, P>(dkv, cluster, out, name);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class P>
Launch pick(int hd) {
  switch (hd) {
    case 16: return launch<16, P>;
    case 32: return launch<32, P>;
    case 64: return launch<64, P>;
    case 128: return launch<128, P>;
    default: return nullptr;
  }
}

}  // namespace

// q, o, dout, dq (b, sq, h, hd); k, v, dk, dv (b, sk, kvh, hd); all contiguous,
// 16-byte aligned and of one dtype, h a multiple of kvh, hd in {16, 32, 64,
// 128}; lse (b, h, sq) f32 from K3's forward; dsum f32 scratch of b * h * sq
// pairs (each row's D and 1 / sum_j P_ij, written by the first kernel for the
// second). cluster: dK/dV blocks per (key tile, KV head, batch), dividing
// h / kvh, at most 8. Query row i sits at position
// q_offset + i, key j at position j; window <= 0 means no window. Each
// returns the CUDA error of its launches, 0 if none.

// Instance i at its launch configuration, for the kernel audit
// (introspect.cuh): i = 8 * bf16 + 2 * (0-3 for hd 16, 32, 64, 128) + (0 dQ,
// 1 dK/dV); cluster: the dK/dV launch's cluster size (at most 8).
extern "C" int flash_attention_bwd_instance(int i, int cluster, int* out,
                                            const char** name) {
  if (i < 0 || i >= 16 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = 16 << ((i % 8) / 2);
  const bool dkv = i % 2 == 1;
  return i < 8 ? query_hd<Tf32x3>(hd, dkv, cluster, out, name)
               : query_hd<Bf16>(hd, dkv, cluster, out, name);
}

extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* dq, void* dk, void* dv, void* dsum, int b,
                                              int sq, int sk, int h, int kvh, int hd,
                                              float scale, int causal, int window,
                                              int q_offset, int cluster, void* stream) {
  Launch fn = pick<Tf32x3>(hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, lse, dq, dk, dv, dsum, b, sq, sk, h, kvh, scale, causal, window,
            q_offset, cluster, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout,
                                               const void* lse, void* dq, void* dk, void* dv,
                                               void* dsum, int b, int sq, int sk, int h,
                                               int kvh, int hd, float scale, int causal,
                                               int window, int q_offset, int cluster,
                                               void* stream) {
  Launch fn = pick<Bf16>(hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, lse, dq, dk, dv, dsum, b, sq, sk, h, kvh, scale, causal, window,
            q_offset, cluster, static_cast<cudaStream_t>(stream));
}
