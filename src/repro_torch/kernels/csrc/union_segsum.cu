// Fused union + segment-sum + FedSubAvg scaling over a cohort's row-sparse
// deltas, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/union_segsum.py:union_segsum.
// That kernel builds the union with a one-hot MXU matmul per (vocab block,
// row block), compacts it with a permutation matmul and carries the union
// offset across a sequential grid in SMEM. None of that fits the GPU, which
// has no ordered grid. Here the union is a V-sized bitmap and a prefix scan:
//
//   1. mark    bitmap[v] = 1 for every id v in [0, V) (other ids dropped)
//   2. scan    exclusive scan of the bitmap: per-tile scan in shared memory,
//              then one block scans the tile totals
//   3. compact rank[v] = global rank; out_ids[rank[v]] = v for rank < cap.
//              Ranks ascend with v, so the union comes out sorted and an
//              overflow drops the largest ids, as unique_ids_padded does
//   4. segsum  each valid element of each row atomically adds its f32 value
//              into out_rows[rank[ids[t]]] when that rank is < cap
//   5. scale   out_rows[s] *= (total / max(heat[v], 1)) * scale, 0 where
//              heat is 0, or scale alone without heat
//
// Bound on the H100: bytes. The work moves the ids (4T), the rows (T*D of
// f32 or bf16), the V-sized bitmap and rank arrays (written and read a few
// times, 4V each pass) and the union output (cap*(4 + 4D)); the arithmetic
// is one add per row element. At the trainer's shapes (V = 37,069, T a few
// thousand to ~13k, D = 1) the V-sized passes dominate the bytes and every
// pass is short, so the five launches cost more than the bytes. The design
// keeps the union in one ordered pass (no sort) and does every pass with
// coalesced loads; fusing the passes is later work.
//
// The atomics make the f32 sum order vary from run to run, so results agree
// with the plain PyTorch version to a tolerance and not bit for bit.
// total and scale are kernel arguments, never compile-time constants.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// inclusive scan of one int per thread over a block of kScanThreads threads
__device__ int block_inclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];  // kScanThreads / 32 == 32 warps
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return x + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void mark_kernel(const int* __restrict__ ids, int t, int num_rows,
                            int* __restrict__ bitmap) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < t;
       i += gridDim.x * blockDim.x) {
    const int v = ids[i];
    if (v >= 0 && v < num_rows) bitmap[v] = 1;
  }
}

// per-tile exclusive scan of the bitmap; tile totals go to tile_sums
__global__ void tile_scan_kernel(const int* __restrict__ bitmap, int num_rows,
                                 int* __restrict__ rank,
                                 int* __restrict__ tile_sums) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int vals[kScanItems];
  int local = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    vals[k] = (base + k < num_rows) ? bitmap[base + k] : 0;
    local += vals[k];
  }
  const int incl = block_inclusive_scan(local, warp_sums);
  int excl = incl - local;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < num_rows) rank[base + k] = excl;
    excl += vals[k];
  }
  if (threadIdx.x == kScanThreads - 1) tile_sums[blockIdx.x] = incl;
}

// in-place exclusive scan of the tile totals by one block, chunk by chunk
__global__ void tile_offsets_kernel(int* __restrict__ tile_sums, int ntiles) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int start = 0; start < ntiles; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int v = i < ntiles ? tile_sums[i] : 0;
    const int c = carry;
    const int incl = block_inclusive_scan(v, warp_sums);
    if (i < ntiles) tile_sums[i] = c + incl - v;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == kScanThreads - 1) carry = c + incl;
    __syncthreads();
  }
}

__global__ void compact_kernel(const int* __restrict__ bitmap,
                               int* __restrict__ rank,
                               const int* __restrict__ tile_offsets,
                               int num_rows, int cap, int* __restrict__ out_ids) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_rows) return;
  const int r = rank[v] + tile_offsets[v / kScanTile];
  rank[v] = r;
  if (bitmap[v] && r < cap) out_ids[r] = v;
}

template <typename T>
__global__ void segsum_kernel(const int* __restrict__ ids,
                              const T* __restrict__ rows, int t, int d,
                              int num_rows, const int* __restrict__ rank,
                              int cap, float* __restrict__ out_rows) {
  const int64_t n = static_cast<int64_t>(t) * d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / d;
    const int v = ids[row];
    if (v < 0 || v >= num_rows) continue;
    const int r = rank[v];
    if (r >= cap) continue;
    atomicAdd(out_rows + static_cast<int64_t>(r) * d + (i - row * d),
              to_f32(rows[i]));
  }
}

__global__ void scale_kernel(const int* __restrict__ out_ids,
                             const float* __restrict__ heat, float total,
                             float scale, int cap, int d,
                             float* __restrict__ out_rows) {
  const int64_t n = static_cast<int64_t>(cap) * d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int v = out_ids[i / d];
    if (v < 0) continue;  // padding slots keep their zero rows
    float f = scale;
    if (heat != nullptr) {
      const float h = heat[v];
      f = h > 0.f ? (total / fmaxf(h, 1.f)) * scale : 0.f;
    }
    out_rows[i] *= f;
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

}  // namespace

// ids (t,) int32; rows (t, d) f32 or bf16 (rows_bf16 != 0); heat (num_rows,)
// f32 or null. Scratch: bitmap (num_rows,) zeroed, rank (num_rows,),
// tile_sums (ceil(num_rows / 4096),). Outputs: out_ids (cap,) filled with -1,
// out_rows (cap, d) zeroed. Returns the CUDA error of the launches, 0 if none.
extern "C" int union_segsum_launch(const void* ids, const void* rows,
                                   int rows_bf16, const void* heat,
                                   float total, float scale, int t, int d,
                                   int num_rows, int cap, void* bitmap,
                                   void* rank, void* tile_sums, void* out_ids,
                                   void* out_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids_p = static_cast<const int*>(ids);
  int* bitmap_p = static_cast<int*>(bitmap);
  int* rank_p = static_cast<int*>(rank);
  int* tiles_p = static_cast<int*>(tile_sums);
  int* out_ids_p = static_cast<int*>(out_ids);
  float* out_rows_p = static_cast<float*>(out_rows);
  const int ntiles = (num_rows + kScanTile - 1) / kScanTile;

  mark_kernel<<<blocks_for(t), kThreads, 0, s>>>(ids_p, t, num_rows, bitmap_p);
  tile_scan_kernel<<<ntiles, kScanThreads, 0, s>>>(bitmap_p, num_rows, rank_p,
                                                    tiles_p);
  tile_offsets_kernel<<<1, kScanThreads, 0, s>>>(tiles_p, ntiles);
  compact_kernel<<<(num_rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      bitmap_p, rank_p, tiles_p, num_rows, cap, out_ids_p);
  const int64_t n = static_cast<int64_t>(t) * d;
  if (rows_bf16) {
    segsum_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        ids_p, static_cast<const __nv_bfloat16*>(rows), t, d, num_rows, rank_p,
        cap, out_rows_p);
  } else {
    segsum_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        ids_p, static_cast<const float*>(rows), t, d, num_rows, rank_p, cap,
        out_rows_p);
  }
  scale_kernel<<<blocks_for(static_cast<int64_t>(cap) * d), kThreads, 0, s>>>(
      out_ids_p, static_cast<const float*>(heat), total, scale, cap, d,
      out_rows_p);
  return static_cast<int>(cudaGetLastError());
}
