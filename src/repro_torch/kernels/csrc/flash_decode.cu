// Single-token flash decode against a (possibly ring-buffer) KV cache, for
// Hopper (sm_90a): the attention of every decode step.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode.
// That kernel runs the grid (B*H, cache blocks) with the cache axis in order,
// carries m, l and acc in VMEM scratch, and reads each KV head's cache once
// for every one of the H/KV query heads that share it. Here:
//
//   pass 1  one block per (batch, KV head, group of up to 8 of its query
//           heads, slice of the cache). The slice is cut into tiles of 64
//           slots. The block first reads the slice's positions and lists the
//           tiles that hold a valid slot (0 <= kpos <= q_position, and kpos >
//           q_position - window when a window is set: ring buffers work by
//           position value); the others are never copied. The listed tiles'
//           K and V rows (contiguous in the (B, KV, S, hd) cache) stream into
//           a two-stage ring in shared memory by bulk copies that complete on
//           an mbarrier, issued by one thread. Per tile, one max, one
//           exp(m - m') rescale and one sum per head, never one per slot;
//           then the block writes (m, l, acc) for its slice. The arithmetic
//           depends on the dtype:
//           bf16 (split_kernel_tc): tensor cores. Warp w owns slots 16w..
//             16w+15 of each tile and keeps its own m, l and acc; S = Q K^T
//             and P V are mma.sync.m16n8k16 with the block's heads as the
//             rows (Q's fragments held in registers, K and V fragments by
//             ldmatrix), f32 sums. The tiles come by the tensor form of the
//             bulk copy (a 2-D map over the cache's rows, encoded per call),
//             because ldmatrix needs the rows swizzled: a K or V row is 256
//             bytes at hd 128, so the 8 rows one ldmatrix reads would share a
//             bank group 8 ways in a plain copy, and one 1-D copy per padded
//             row is 128 small copies per tile. p is rounded to bf16 for the PV product, as
//             decode_attention rounds its p to the cache's dtype (there the
//             normalised p; an online softmax only holds the unnormalised
//             one, so the two roundings differ, within the 2e-2 tolerance
//             and 1e-2 in relative norm). The warps join by log-sum-exp once.
//           f32 (split_kernel): CUDA cores, all in f32 as f32 comparisons
//             need (TF32 tensor cores keep about three digits); tiles by
//             1-D cp.async.bulk, two copies per tile. Two threads
//             score each slot for all heads from 16-byte shared-memory reads
//             (one shuffle joins their halves); each thread then accumulates
//             p V for one 16-byte column chunk of every head. p stays f32 in
//             the PV product, as in the TPU kernel
//             (src/repro/kernels/flash_decode.py:80 multiplies its f32 p by v
//             in f32).
//   pass 2  (merge_kernel) one block per (batch, query head) merges the
//           slices by log-sum-exp: M = max m_i, L = sum l_i e^(m_i - M),
//           out = sum acc_i e^(m_i - M) / L, in the inputs' dtype. The merge
//           stays a second small launch. Its log-sum-exp instance (kLse,
//           asked for by a non-null lse) is the per-rank form of a cache
//           split by sequence over ranks: it writes out in f32, unrounded,
//           and lse = M + log L, so that the ranks' partials merge once more
//           across ranks (sharding/parallel.py::merge_decode_partials) and
//           are rounded once, after that merge. A row with no valid slot in
//           the rank's slice gets lse = -inf and the mean of V over the
//           slice's slots.
//
// This is the split-K form the TPU kernel's docstring names for its sharded
// path. Scores are q.k / sqrt(hd) in f32, as repro/models/layers.py::
// decode_attention computes them. A (batch, head) with no valid slot gets
// the mean of V over all S slots, as both references give it (every score
// is then -1e30, so every p is 1): the merge takes that path only when every
// slice's max is -inf, and reads the KV head's V there, so the common path
// pays nothing for it.
//
// Bound on the H100: bytes. At the serving decode step (B 4, KV 8, 1,056
// slots, hd 128, bf16) the step must read the 17.3 MB of valid cache once
// (5.2 us at 3.35 TB/s); the flops are ~1e8. The wrapper's split_plan cuts
// the cache into slices of whole tiles so that a few hundred blocks (two or
// three per SM at ~70 KB of shared memory each) have all their tiles in
// flight at once. With the CUDA-core arithmetic on bf16 the split pass was
// held back by its instructions, not by its bytes, which is why bf16 runs on
// the tensor cores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "introspect.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per block
constexpr int kTile = 64;      // slots per tile (kernels/flash_decode.py TILE)
constexpr int kStages = 2;     // tiles in flight per block
static_assert(2 * kTile == kThreads, "two threads score each slot of a tile");

template <typename T, int HD>
struct Rows {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements per 16 B
  static constexpr int kChunks = HD / kVec;                        // 16-byte chunks per row
  static constexpr int kTileElems = kTile * HD;
  // K and V stages, then the tile list
  static constexpr int kStageBytes = 2 * kStages * kTileElems * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the 16 bytes at p as f32
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ bool slot_valid(int kpos, int q_position, int window) {
  return kpos >= 0 && kpos <= q_position && (window <= 0 || kpos > q_position - window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one contiguous global -> shared copy of `bytes` (a multiple of 16),
// completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// part layout: (b, h, nsplit, HD + 2) f32 holding m, l, acc[HD]
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ kpos, int q_position, int window, int h, int kvh,
             int s_len, int chunk, int nsplit, float sqrt_hd, float* __restrict__ part) {
  using R = Rows<T, HD>;
  constexpr int kVec = R::kVec, kChunks = R::kChunks;
  constexpr int kHalf = kChunks / 2;                 // chunks per scoring thread
  constexpr int kGroups = kThreads / kChunks;        // slot groups of the PV step
  extern __shared__ __align__(128) uint8_t smem[];
  T* kbuf = reinterpret_cast<T*>(smem);              // stage s at kbuf + s * kTileElems
  T* vbuf = kbuf + kStages * R::kTileElems;
  int* tiles = reinterpret_cast<int*>(smem + R::kStageBytes);
  __shared__ float q_s[kMaxG][HD];
  __shared__ float sc[kMaxG][kTile];                 // scores, then p
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int n_live;
  __shared__ __align__(8) uint64_t full[kStages];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = h / kvh;
  const int gchunks = (groups + kMaxG - 1) / kMaxG;
  const int kv_head = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * kMaxG;
  const int ng = min(kMaxG, groups - g0);
  const int head0 = kv_head * groups + g0;   // first query head of the block
  const int64_t base = (static_cast<int64_t>(b) * kvh + kv_head) * s_len;
  const int s_begin = split * chunk, s_end = min(s_len, s_begin + chunk);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile : 0;

  for (int i = tid; i < kMaxG * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = g < ng ? to_f32(q[(static_cast<int64_t>(b) * h + head0 + g) * HD + d]) : 0.f;
  }
  for (int i = tid; i < n_tiles; i += kThreads) tiles[i] = 0;
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // tiles that hold a valid slot; the rest are never copied
  for (int s = s_begin + tid; s < s_end; s += kThreads)
    if (slot_valid(kpos[s], q_position, window)) tiles[(s - s_begin) / kTile] = 1;
  __syncthreads();

  auto issue = [&](int i) {   // the i-th listed tile into stage i % kStages
    const int st = i % kStages, t0 = s_begin + tiles[i] * kTile;
    const uint32_t bytes = min(kTile, s_end - t0) * HD * static_cast<int>(sizeof(T));
    const uint32_t bar = smem_u32(&full[st]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(2 * bytes) : "memory");
    bulk_load(smem_u32(kbuf + st * R::kTileElems), kc + (base + t0) * HD, bytes, bar);
    bulk_load(smem_u32(vbuf + st * R::kTileElems), vc + (base + t0) * HD, bytes, bar);
  };
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    n_live = n;
    for (int i = 0; i < min(n, kStages); ++i) issue(i);
  }
  __syncthreads();
  const int n = n_live;

  float acc[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  const int pc = tid % kChunks, pj = tid / kChunks;   // PV: column chunk, slot group

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int t0 = s_begin + tiles[i] * kTile, rows = min(kTile, s_end - t0);
    mbar_wait(smem_u32(&full[st]), (i / kStages) & 1);
    const T* kt = kbuf + st * R::kTileElems;
    const T* vt = vbuf + st * R::kTileElems;

    // scores of every slot for all heads: two threads per slot, one half of
    // the row each, chunks visited in a rotated order against bank conflicts
    {
      const int slot = tid / 2, half = tid % 2;
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      if (slot < rows) {
#pragma unroll
        for (int c = 0; c < kHalf; ++c) {
          const int cc = half * kHalf + (c + slot) % kHalf;
          float kv[kVec];
          load16(kt + slot * HD + cc * kVec, kv);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g >= ng) break;
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot[g] = fmaf(q_s[g][cc * kVec + e], kv[e], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
      if (half == 0) {
        const bool ok = slot < rows && slot_valid(kpos[t0 + slot], q_position, window);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < ng) sc[g][slot] = ok ? dot[g] / sqrt_hd : -INFINITY;
      }
    }
    __syncthreads();

    // one max, one rescale and one sum per tile and head (a warp per head)
    for (int g = warp; g < ng; g += kWarps) {
      const float s0 = sc[g][lane], s1 = sc[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);   // finite: the tile is listed
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sc[g][lane] = p0;
      sc[g][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V over this thread's slots, for its column chunk
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float corr = g < ng ? corr_s[g] : 1.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
    }
    for (int slot = pj; slot < rows; slot += kGroups) {
      float vv[kVec];
      load16(vt + slot * HD + pc * kVec, vv);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= ng) break;
        const float p = sc[g][slot];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    __syncthreads();   // the stage and the scores are free again
    if (tid == 0 && i + kStages < n) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i + kStages);
    }
  }

  // join the slot groups: lanes of a warp with the same chunk by shuffles,
  // then the warps through shared memory (the stage buffers, now idle)
#pragma unroll
  for (int off = kChunks; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  float* red = reinterpret_cast<float*>(smem);   // (kWarps, kMaxG, HD)
  if (lane < kChunks) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[(warp * kMaxG + g) * HD + pc * kVec + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t stride = HD + 2;
  for (int i = tid; i < ng * (HD + 2); i += kThreads) {
    const int g = i / (HD + 2), c = i % (HD + 2);
    float val;
    if (c == 0) {
      val = m_s[g];
    } else if (c == 1) {
      val = l_s[g];
    } else {
      val = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) val += red[(w * kMaxG + g) * HD + c - 2];
    }
    part[((static_cast<int64_t>(b) * h + head0 + g) * nsplit + split) * stride + c] = val;
  }
}

// ---------------------------------------------------------------------------
// bf16: the split pass on the tensor cores (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

// A K or V tile in shared memory as the tensor copy writes it: hd/box boxes
// of 64 rows x kSwizzle bytes, each row's 16-byte chunks XOR-swizzled by the
// row, so that the 8 rows an ldmatrix reads fall in 8 different bank groups
template <int HD>
struct SwizzledTile {
  static constexpr int kSwizzle = HD * 2 >= 128 ? 128 : HD * 2;   // bytes per box row
  static constexpr int kBox = kSwizzle / 2;                         // elements per box row
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kTileBytes = kTile * HD * 2;                 // one of K or V
  static constexpr int kStageBytes = 2 * kStages * kTileBytes;      // K and V stages
  // shared address of (row, col) in the tile at `base` (1024-byte aligned)
  static __device__ __forceinline__ uint32_t at(uint32_t base, int row, int col) {
    uint32_t off = (col / kBox) * (kTile * kSwizzle) + row * kSwizzle + (col % kBox) * 2;
    off ^= ((off >> 7) & (kSwizzle / 16 - 1)) << 4;
    return base + off;
  }
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, rows 8-15 zero) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block per (batch, KV head, group of up to 8 query heads, slice). Warp
// w owns slots 16w..16w+15 of every tile and keeps its own m, l and acc for
// the block's heads (the rows of the mma; rows 8-15 are padding), so the
// warps need no barrier inside a tile; they are joined by log-sum-exp once,
// at the end. Per tile and warp: S = Q K^T is two n8 slot groups x hd/16
// k-steps, with Q's A fragments held in registers for the whole slice and
// K's B fragments from ldmatrix; p is rounded to bf16 and its C fragments
// are the A fragments of the PV product (one k-step of 16 slots, hd/8 n8
// column groups, V's B fragments from ldmatrix.trans). The tiles arrive by
// tensor copies over the cache seen as (B * KV * S) rows of hd: a tile past
// the end of a (batch, KV head)'s slots reads the next one's rows (finite,
// and masked) or, at the end of the cache, zeros.
template <int HD>
__global__ void __launch_bounds__(kThreads)
split_kernel_tc(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                const int* __restrict__ kpos, int q_position, int window, int h, int kvh,
                int s_len, int chunk, int nsplit, float sqrt_hd, float* __restrict__ part) {
  using R = SwizzledTile<HD>;
  constexpr int kSteps = HD / 16, kCols = HD / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t kbuf = smem_u32(smem);                     // stage s at + s * kTileBytes
  const uint32_t vbuf = kbuf + kStages * R::kTileBytes;
  int* tiles = reinterpret_cast<int*>(smem + R::kStageBytes);
  __shared__ float m_w[kWarps][kMaxG], l_w[kWarps][kMaxG];
  __shared__ int n_live;
  __shared__ __align__(8) uint64_t full[kStages];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = h / kvh;
  const int gchunks = (groups + kMaxG - 1) / kMaxG;
  const int kv_head = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y % gchunks) * kMaxG;
  const int ng = min(kMaxG, groups - g0);
  const int head0 = kv_head * groups + g0;
  const int base = (b * kvh + kv_head) * s_len;   // first row of this KV head's slots
  const int s_begin = split * chunk, s_end = min(s_len, s_begin + chunk);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile : 0;
  const int row = lane / 4, quad = lane % 4;   // mma fragment coordinates

  // Q's A fragments (row = query head of the block, k = dim); the loads are
  // in flight while the slice's positions are read
  uint32_t qa[kSteps][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (static_cast<int64_t>(b) * h + head0 + row) * HD);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qa[kk][0] = row < ng ? qrow[8 * kk + quad] : 0u;
      qa[kk][1] = row < ng ? qrow[8 * kk + 4 + quad] : 0u;
    }
  }

  for (int i = tid; i < n_tiles; i += kThreads) tiles[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int s = s_begin + tid; s < s_end; s += kThreads)
    if (slot_valid(kpos[s], q_position, window)) tiles[(s - s_begin) / kTile] = 1;
  __syncthreads();

  // one thread lists the tiles with a valid slot and streams them
  auto issue = [&](int i) {
    const int st = i % kStages, r0 = base + s_begin + tiles[i] * kTile;
    const uint32_t bar = smem_u32(&full[st]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(2 * R::kTileBytes) : "memory");
    for (int c = 0; c < R::kBoxes; ++c) {
      tma_load_2d(kbuf + st * R::kTileBytes + c * kTile * R::kSwizzle, &tm_k, bar,
                  c * R::kBox, r0);
      tma_load_2d(vbuf + st * R::kTileBytes + c * kTile * R::kSwizzle, &tm_v, bar,
                  c * R::kBox, r0);
    }
  };
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    n_live = n;
    for (int i = 0; i < min(n, kStages); ++i) issue(i);
  }
  __syncthreads();
  const int n = n_live;

  float acc[kCols][4];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m = -INFINITY, l = 0.f;   // of head `row`, over this warp's slots

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int t0 = s_begin + tiles[i] * kTile;
    const int n0 = 16 * warp;   // this warp's first slot in the tile
    // the positions of this thread's 4 slots, read before the data arrives
    bool ok[2][2];
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = t0 + n0 + 8 * g + 2 * quad + e;
        ok[g][e] = slot < s_end && slot_valid(kpos[slot], q_position, window);
      }
    mbar_wait(smem_u32(&full[st]), (i / kStages) & 1);
    const uint32_t kt = kbuf + st * R::kTileBytes, vt = vbuf + st * R::kTileBytes;

    // S = Q K^T for slot groups n0.. and n0 + 8..
    float s[2][4];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[g][e] = 0.f;
      const int krow = n0 + 8 * g + lane % 8;
      if constexpr (kSteps == 1) {
        uint32_t b0, b1;
        ldsm_x2(R::at(kt, krow, 8 * (lane / 8 % 2)), b0, b1);
        mma_bf16(s[g], qa[0][0], qa[0][1], b0, b1);
      } else {
#pragma unroll
        for (int kk = 0; kk < kSteps; kk += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(R::at(kt, krow, 16 * kk + 8 * (lane / 8)), b0, b1, b2, b3);
          mma_bf16(s[g], qa[kk][0], qa[kk][1], b0, b1);
          mma_bf16(s[g], qa[kk + 1][0], qa[kk + 1][1], b2, b3);
        }
      }
    }

    // mask, then one max, one rescale and one sum per head over the tile's
    // 16 slots of this warp (a head's values sit in the 4 lanes of a quad)
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[g][e] = ok[g][e] ? s[g][e] / sqrt_hd : -INFINITY;
        mx = fmaxf(mx, s[g][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no valid slot yet
    const float corr = expf(m - m_use);
    float p[2][2], sum = 0.f;
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[g][e] = expf(s[g][e] - m_use);
        sum += p[g][e];
      }
    l = l * corr + sum;
    m = m_new;
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);

    // acc = acc * corr + P V over the warp's 16 slots, hd/8 column groups
    const int vrow = n0 + 8 * (lane / 8 % 2) + lane % 8;
#pragma unroll
    for (int j = 0; j < kCols; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(R::at(vt, vrow, 8 * j + 8 * (lane / 16)), b0, b1, b2, b3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] *= corr;
        acc[j + 1][e] *= corr;
      }
      mma_bf16(acc[j], pa0, pa2, b0, b1);
      mma_bf16(acc[j + 1], pa0, pa2, b2, b3);
    }
    __syncthreads();   // every warp is done with the stage
    if (tid == 0 && i + kStages < n) issue(i + kStages);
  }

  // join the warps by log-sum-exp through shared memory (the idle stages)
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* red = reinterpret_cast<float*>(smem);   // (kWarps, kMaxG, HD)
  if (quad == 0) {
    m_w[warp][row] = m;
    l_w[warp][row] = l;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    red[(warp * kMaxG + row) * HD + 8 * j + 2 * quad] = acc[j][0];
    red[(warp * kMaxG + row) * HD + 8 * j + 2 * quad + 1] = acc[j][1];
  }
  __syncthreads();
  const int64_t stride = HD + 2;
  for (int i = tid; i < ng * (HD + 2); i += kThreads) {
    const int g = i / (HD + 2), c = i % (HD + 2);
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    float val = mx;
    if (c > 0) {
      val = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(m_w[w][g] - mx);
          val += f * (c == 1 ? l_w[w][g] : red[(w * kMaxG + g) * HD + c - 2]);
        }
      }
    }
    part[((static_cast<int64_t>(b) * h + head0 + g) * nsplit + split) * stride + c] = val;
  }
}

// the cache as (rows, hd) bf16 with a (box, 64) box under the row's swizzle
template <int HD>
bool encode_cache(CUtensorMap* map, const void* ptr, int64_t rows) {
  using R = SwizzledTile<HD>;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(HD) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(R::kBox), kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = R::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : R::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kLse: out is f32 and lse (b * h) gets M + log L, -inf for a row with no
// valid slot; otherwise out is in the inputs' dtype and lse is unused
template <typename T, int HD, bool kLse>
__global__ void merge_kernel(const float* __restrict__ part, const T* __restrict__ vc,
                             int h, int kvh, int s_len, int nsplit,
                             std::conditional_t<kLse, float, T>* __restrict__ out,
                             float* __restrict__ lse) {
  const int bh = blockIdx.x;   // b * h + head
  const int64_t stride = HD + 2;
  const float* pp = part + static_cast<int64_t>(bh) * nsplit * stride;
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, pp[i * stride]);
  if (mx == -INFINITY) {
    // no valid slot: the references' scores all tie at -1e30 and every p
    // is 1, so the row is the mean of V over all S slots
    const int b = bh / h, kv_head = (bh % h) / (h / kvh);
    const T* vb = vc + (static_cast<int64_t>(b) * kvh + kv_head) * s_len * HD;
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      float a = 0.f;
      for (int s = 0; s < s_len; ++s) a += to_f32(vb[static_cast<int64_t>(s) * HD + d]);
      store(out + static_cast<int64_t>(bh) * HD + d, a / static_cast<float>(s_len));
    }
    if (kLse && threadIdx.x == 0) lse[bh] = -INFINITY;
    return;
  }
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const float f = expf(pp[i * stride] - mx);
      l += f * pp[i * stride + 1];
      a += f * pp[i * stride + 2 + d];
    }
    store(out + static_cast<int64_t>(bh) * HD + d, a / l);
    if (kLse && d == 0) lse[bh] = mx + logf(l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* kpos, int b,
           int h, int kvh, int s_len, int q_position, int window, int nsplit,
           int chunk, float sqrt_hd, float* part, void* out, float* lse,
           cudaStream_t stream) {
  const int gchunks = (h / kvh + kMaxG - 1) / kMaxG;
  const dim3 grid(nsplit, kvh * gchunks, b);
  const int list = 4 * ((chunk + kTile - 1) / kTile);   // bytes of the tile list
  // the split pass: bf16 on the tensor cores, f32 on the CUDA cores
  if constexpr (sizeof(T) == 2) {
    CUtensorMap tk, tv;
    const int64_t rows = static_cast<int64_t>(b) * kvh * s_len;
    if (!encode_cache<HD>(&tk, kc, rows) || !encode_cache<HD>(&tv, vc, rows))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = split_kernel_tc<HD>;
    const int bytes = SwizzledTile<HD>::kStageBytes + 1024 + list;   // + alignment slack
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, bytes, stream>>>(
        tk, tv, static_cast<const __nv_bfloat16*>(q), kpos, q_position, window, h, kvh,
        s_len, chunk, nsplit, sqrt_hd, part);
  } else {
    auto kernel = split_kernel<T, HD>;
    const int bytes = Rows<T, HD>::kStageBytes + list;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        kpos, q_position, window, h, kvh, s_len, chunk, nsplit, sqrt_hd, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lse != nullptr)
    merge_kernel<T, HD, true><<<b * h, HD < 32 ? 32 : HD, 0, stream>>>(
        part, static_cast<const T*>(vc), h, kvh, s_len, nsplit, static_cast<float*>(out),
        lse);
  else
    merge_kernel<T, HD, false><<<b * h, HD < 32 ? 32 : HD, 0, stream>>>(
        part, static_cast<const T*>(vc), h, kvh, s_len, nsplit, static_cast<T*>(out),
        nullptr);
  return static_cast<int>(cudaGetLastError());
}

// the split pass (tensor cores for bf16, CUDA cores for f32) with `chunk`
// slots a slice, or the merge (its log-sum-exp instance with lse), at its
// launch configuration
template <typename T, int HD>
int query_instance(bool merge, bool lse, int chunk, int* out, const char** name) {
  if (merge)
    return introspect::query(
        lse ? reinterpret_cast<const void*>(merge_kernel<T, HD, true>)
            : reinterpret_cast<const void*>(merge_kernel<T, HD, false>),
        HD < 32 ? 32 : HD, 0, 1, out, name);
  const int list = 4 * ((chunk + kTile - 1) / kTile);
  if constexpr (sizeof(T) == 2)
    return introspect::query(reinterpret_cast<const void*>(split_kernel_tc<HD>), kThreads,
                             SwizzledTile<HD>::kStageBytes + 1024 + list, 1, out, name);
  else
    return introspect::query(reinterpret_cast<const void*>(split_kernel<T, HD>), kThreads,
                             Rows<T, HD>::kStageBytes + list, 1, out, name);
}

template <typename T>
int query_hd(int hd, bool merge, bool lse, int chunk, int* out, const char** name) {
  switch (hd) {
    case 16: return query_instance<T, 16>(merge, lse, chunk, out, name);
    case 32: return query_instance<T, 32>(merge, lse, chunk, out, name);
    case 64: return query_instance<T, 64>(merge, lse, chunk, out, name);
    case 128: return query_instance<T, 128>(merge, lse, chunk, out, name);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int hd, const void* q, const void* kc, const void* vc, const int* kpos,
             int b, int h, int kvh, int s_len, int q_position, int window, int nsplit,
             int chunk, float sqrt_hd, float* part, void* out, float* lse, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, lse, s);
    case 32: return launch<T, 32>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, lse, s);
    case 64: return launch<T, 64>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, lse, s);
    case 128: return launch<T, 128>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, lse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out (b, h, hd); k_cache, v_cache (b, kvh, s_len, hd); all contiguous and
// 16-byte aligned, f32 or bf16 (is_bf16 != 0); k_positions (s_len,) int32, -1
// for an empty slot; h a multiple of kvh; hd in {16, 32, 64, 128}. The cache
// is cut into nsplit slices of chunk slots; part is f32 scratch of b * h *
// nsplit * (hd + 2). window <= 0 means no window. lse null: out in the
// inputs' dtype; lse (b * h f32): out in f32 and lse the rows' log-sum-exp.
// Returns the CUDA error of the launches.
// Instance i at its launch configuration, for the kernel audit
// (introspect.cuh): i = 8 * merge + 4 * bf16 + (0-3 for hd 16, 32, 64, 128)
// for i < 16, and i = 16 + 4 * bf16 + (0-3) for the merge's log-sum-exp
// instance; chunk: the split pass's slots a slice (split_plan), which sizes
// its list.
extern "C" int flash_decode_instance(int i, int chunk, int* out, const char** name) {
  if (i < 0 || i >= 24 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = 16 << (i % 4);
  const bool lse = i >= 16, merge = i >= 8, bf16 = (i / 4) % 2 == 1;
  return bf16 ? query_hd<__nv_bfloat16>(hd, merge, lse, chunk, out, name)
              : query_hd<float>(hd, merge, lse, chunk, out, name);
}

extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_positions,
                                   int is_bf16, int b, int h, int kvh, int s_len,
                                   int hd, int q_position, int window, int nsplit,
                                   int chunk, float sqrt_hd, void* part, void* out,
                                   void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kpos = static_cast<const int*>(k_positions);
  float* pp = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k_cache, v_cache, kpos, b, h, kvh, s_len,
                                   q_position, window, nsplit, chunk, sqrt_hd, pp,
                                   out, ls, s);
  return dispatch<float>(hd, q, k_cache, v_cache, kpos, b, h, kvh, s_len, q_position,
                         window, nsplit, chunk, sqrt_hd, pp, out, ls, s);
}
