// Fused union + segment-sum + FedSubAvg scaling over a cohort's row-sparse
// deltas, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/union_segsum.py:union_segsum.
// That kernel builds the union with a one-hot MXU matmul per (vocab block,
// row block), compacts it with a permutation matmul and carries the union
// offset across a sequential grid in SMEM. None of that fits the GPU, which
// has no ordered grid. Here the union is a bitmap of one bit per table row
// and a prefix count over its 32-bit words, in ONE cooperative launch whose
// phases are separated by grid-wide barriers:
//
//   1. zero    the bit words (the kernel clears its own scratch: nothing
//              is carried between calls)
//   2. mark    atomicOr of bit v & 31 of word v >> 5 for every id v in
//              [0, V); other ids are dropped in every phase
//   3. count   each block pops the bits of its chunk of words
//   4. rank    each block adds the counts of the blocks before it, scans its
//              chunk in shared memory, stores each word's rank offset beside
//              its bits, writes its part of out_ids (a word's ids by
//              consecutive lanes) and -1 over [min(union, cap), cap), and
//              zeroes out_rows. The rank of id v is
//              offset[v >> 5] + popc(bits[v >> 5] & ((1 << (v & 31)) - 1)):
//              ranks ascend with v, so the union comes out sorted and an
//              overflow over cap drops the largest ids, as
//              unique_ids_padded and the TPU kernel's capacity drop do
//   5. segsum  a team of threads per row (rowsum.cuh): each lane of a team
//              resolves one of `team` rows at once (id, then its word's
//              rank, then its heat: a chain of dependent loads), and the
//              team adds the rows, each times its factor, into
//              out_rows[rank] with float4 / float2 atomics where D and the
//              address allow, scalar ones for the ragged widths (D = 1, 25)
//
// The factor (total / max(heat[v], 1)) * scale, 0 where heat is 0 (scale
// alone without heat), multiplies each row before its atomic add instead of
// the sum after it: that saves a fifth barrier and a pass over cap * D. The
// reference sums, then scales; the two differ by one f32 rounding per row,
// of the order of the atomics' own reordering, and every case of
// chip_smoke.py [2] holds the kernel to the plain version's tolerance.
//
// What bounds it on the H100. The work has to move the ids (4T), the rows
// (T*D of f32 or bf16), heat at the union and the outputs (cap * (4 + 4D)).
// At the trainer's shape (V = 37,069, T = 12,800, D = 1) that is ~0.1 MB:
// the call is latency, set by its launch and four barriers and by the
// wrapper's host time, where it was nine device operations (three fills, six
// launches). At a large table (V = 2^22, T = 512k, D = 18, ~79 MB) the
// segment-sum takes the most time, and it was bound by the latency of its
// chain of dependent loads (the id, then its word, then its heat, then the
// row before its atomic add) more than by the atomics themselves
// (tools/aggregation_phases.py times each phase, and the segment-sum with
// and without its atomics). So each lane of a team resolves one of `team`
// rows at once, and the team issues the loads of a group of rows before
// their atomics (rowsum.cuh). The rows are read in 8-
// or 16-byte loads that skip L1. The scratch is one uint2 (bits, rank
// offset) per 32 table rows, V/4 bytes, and one int per block, against the
// 8V bytes of a V-sized bitmap and rank. Two blocks of 512 threads per SM
// leave each thread 64 registers for a group's loads.
//
// Reads of what other blocks wrote in an earlier phase go through L2
// (__ldcg): L1 is not coherent across blocks, and a barrier does not clear
// it. The atomics make the f32 sum order vary from run to run, so results
// agree with the plain PyTorch version to a tolerance and not bit for bit.
// total and scale are kernel arguments, never compile-time constants.

#include "rowsum.cuh"

namespace {

using rowsum::kThreads;
constexpr int kWarps = kThreads / 32;

struct Args {
  const int* ids;      // (t,)
  const void* rows;    // (t, d) f32 or bf16
  const float* heat;   // (num_rows,) or null
  float total, scale;
  int t, d, num_rows, cap;
  int team;            // threads per row: a power of two, at most 32
  uint2* words;        // (ceil(num_rows / 32),): .x bits, .y rank of bit 0
  int* block_sums;     // (gridDim.x,)
  int* out_ids;        // (cap,)
  float* out_rows;     // (cap, d)
};

// Sum of x over the block, returned to every thread.
__device__ int block_sum(int x, int* red) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // red is free from its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = (threadIdx.x & 31) < kWarps ? red[threadIdx.x & 31] : 0;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Exclusive scan of x over the block; *total gets the block's sum.
__device__ int block_exclusive_scan(int x, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int w = lane < kWarps ? red[lane] : 0;  // every warp scans the warp totals
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, off);
    if (lane >= off) w += y;
  }
  const int before = __shfl_sync(0xffffffffu, w, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, w, kWarps - 1);
  return (warp ? before : 0) + incl - x;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, rowsum::kMinBlocksPerSm)
union_segsum_kernel(Args a) {
  __shared__ int red[kWarps];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gs = static_cast<int64_t>(gridDim.x) * kThreads;
  const int words = (a.num_rows + 31) >> 5;

  // 1. zero the bit words
  for (int64_t i = gt; i < words; i += gs) a.words[i] = make_uint2(0u, 0u);
  grid.sync();

  // 2. mark
  for (int64_t i = gt; i < a.t; i += gs) {
    const int v = __ldg(a.ids + i);
    if (v >= 0 && v < a.num_rows) atomicOr(&a.words[v >> 5].x, 1u << (v & 31));
  }
  grid.sync();

  // 3. count
  const int chunk = (words + gridDim.x - 1) / gridDim.x;
  const int lo = min(words, static_cast<int>(blockIdx.x) * chunk);
  const int hi = min(words, lo + chunk);
  int n = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) n += __popc(__ldcg(&a.words[i].x));
  n = block_sum(n, red);
  if (threadIdx.x == 0) a.block_sums[blockIdx.x] = n;
  grid.sync();

  // 4. rank
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    const int s = __ldcg(a.block_sums + i);
    total += s;
    if (i < static_cast<int>(blockIdx.x)) before += s;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + threadIdx.x;
    const unsigned bits = i < hi ? __ldcg(&a.words[i].x) : 0u;
    int step;
    const int rank = before + block_exclusive_scan(__popc(bits), red, &step);
    if (i < hi) a.words[i].y = static_cast<unsigned>(rank);
    // A word's ids take consecutive ranks: the warp writes its non-empty
    // words one at a time, each word's ids by consecutive lanes (the bit of
    // lane n is the word's (n + 1)-th set bit), so a word with many ids is
    // written in full sectors and a warp of dense words does not serialise
    // on its own stores.
    for (unsigned todo = __ballot_sync(0xffffffffu, bits != 0u); todo; todo &= todo - 1) {
      const int w = __ffs(todo) - 1;
      const unsigned wb = __shfl_sync(0xffffffffu, bits, w);
      const int wr = __shfl_sync(0xffffffffu, rank, w);
      if (lane < __popc(wb) && wr + lane < a.cap)
        a.out_ids[wr + lane] = ((i - lane + w) << 5) + static_cast<int>(__fns(wb, 0, lane + 1));
    }
    before += step;
  }
  for (int64_t i = min(total, a.cap) + gt; i < a.cap; i += gs) a.out_ids[i] = -1;
  // out_rows is zeroed here, where the blocks' scans leave the memory
  // system idle; phase 5 is the first to use it
  rowsum::zero_f32(a.out_rows, static_cast<int64_t>(a.cap) * a.d, gt, gs);
  grid.sync();

  // 5. segsum, each row times its id's factor
  rowsum::add_rows<T, VEC>(
      static_cast<const T*>(a.rows), a.out_rows, a.t, a.d, a.team, gt, gs,
      [&](int64_t row, int* slot, float* f) {
        const int v = __ldg(a.ids + row);
        if (v < 0 || v >= a.num_rows) return;
        const uint2 w = __ldcg(a.words + (v >> 5));
        const int r = static_cast<int>(w.y) + __popc(w.x & ((1u << (v & 31)) - 1u));
        if (r >= a.cap) return;
        *slot = r;
        *f = rowsum::heat_factor(a.heat, v, a.total, a.scale);
      });
}

}  // namespace

// Instance i of the kernel (0-5: f32 rows at vec 1, 2, 4, then bf16 rows) at
// its launch configuration, for the kernel audit (introspect.cuh); arg unused.
extern "C" int union_segsum_instance(int i, int arg, int* out, const char** name) {
  (void)arg;
  if (i < 0 || i >= 6) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ROWSUM_PICK(union_segsum_kernel, i / 3, 1 << (i % 3));
  return introspect::query(reinterpret_cast<const void*>(kernel), kThreads, 0, 1, out, name);
}

// Blocks of the kernel instance for (rows_bf16, vec) that fit on the current
// device at once, or a negated CUDA error.
extern "C" int union_segsum_max_blocks(int rows_bf16, int vec) {
  auto kernel = ROWSUM_PICK(union_segsum_kernel, rows_bf16, vec);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return rowsum::max_coresident_blocks(kernel);
}

// ids (t,) int32; rows (t, d) f32 or bf16 (rows_bf16 != 0), rows and out_rows
// aligned to vec elements; heat (num_rows,) f32 or null. vec (4, 2 or 1) and
// team as kernels/_rows.py plans them; blocks at most union_segsum_max_blocks.
// scratch: 2 * ceil(num_rows / 32) + blocks ints, 8-byte aligned, any
// contents. Outputs out_ids (cap,) and out_rows (cap, d), 16-byte aligned,
// any contents: the kernel writes every element. device: the CUDA device the
// pointers and the stream belong to. Returns the launch's CUDA error, 0 if
// none.
extern "C" int union_segsum_launch(const void* ids, const void* rows, int rows_bf16,
                                   const void* heat, float total, float scale, int t,
                                   int d, int num_rows, int cap, int vec, int team,
                                   int blocks, void* scratch, void* out_ids,
                                   void* out_rows, int device, void* stream) {
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.rows = rows;
  a.heat = static_cast<const float*>(heat);
  a.total = total;
  a.scale = scale;
  a.t = t;
  a.d = d;
  a.num_rows = num_rows;
  a.cap = cap;
  a.team = team;
  a.words = static_cast<uint2*>(scratch);
  a.block_sums = static_cast<int*>(scratch) + 2 * ((num_rows + 31) / 32);
  a.out_ids = static_cast<int*>(out_ids);
  a.out_rows = static_cast<float*>(out_rows);
  return rowsum::launch_cooperative(ROWSUM_PICK(union_segsum_kernel, rows_bf16, vec),
                                    blocks, a, device, static_cast<cudaStream_t>(stream));
}
