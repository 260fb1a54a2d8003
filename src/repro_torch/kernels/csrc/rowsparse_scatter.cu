// Fused scatter-add + FedSubAvg correction into a dense (V, D) table, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/heat_scatter.py:rowsparse_scatter
// (heat_scatter is its scale = 1 case). The TPU kernel accumulates a blocked
// one-hot matmul per (vocab block, row block) on the MXU, because the TPU has
// no scatter; the GPU has atomics, as that module's own docstring says. One
// cooperative launch, two phases split by a grid-wide barrier:
//
//   1. zero     out[0:V*D] = 0 in 16-byte stores over the whole grid
//   2. scatter  a team of threads per row (rowsum.cuh): each lane of a team
//               resolves one of `team` rows at once (its id, then the factor
//               (total / max(heat[v], 1)) * scale, 0 where heat is 0), and
//               the team adds the rows, each times its factor, into out[v]
//               with float4 / float2 atomics where D and the address allow,
//               scalar ones for the ragged widths. Ids outside [0, V) are
//               dropped
//
// Bound on the H100: bytes. It must read the ids (4T) and rows (T*D of f32
// or bf16) and write the dense output (4*V*D) once; at every shape the
// module is used at, the output dominates. So the output is written once,
// by the zero phase (as fast as a memset of it), and the atomics touch only
// the rows that the cohort reaches: no zeroed allocation before the launch
// and no scale pass after it (each pass over the output cost as much as the
// whole bound). The scatter phase is latency as K1's segment-sum is, and
// takes the same remedy (rowsum.cuh: rows resolved by a team at once, a
// group's loads before its atomics).
//
// Why one launch with a barrier and not K1's union followed by one coalesced
// pass that writes each dense row as zero or its scaled sum: that route
// writes the output once too, but adds a cap * D scratch of sums (written,
// read back) and the union's bit words, and three more barriers, for a
// write pattern that is deterministic where this one's atomic adds are not.
// Both give the same bytes of output; this one moves fewer in all.
//
// The factor multiplies each row before its atomic add instead of the sum
// after it (the reference: sum, times total / max(heat, 1), times scale).
// The two differ by an f32 rounding or two per row, of the order of the
// atomics' own reordering; every case of chip_smoke.py [3] holds the kernel
// to the plain version's tolerance. The atomics make the f32 sum order vary
// from run to run, so results agree with the plain PyTorch version to a
// tolerance and not bit for bit. total and scale are kernel arguments,
// never compile-time constants.

#include "rowsum.cuh"

namespace {

using rowsum::kThreads;

struct Args {
  const int* ids;      // (t,)
  const void* rows;    // (t, d) f32 or bf16
  const float* heat;   // (num_rows,)
  float total, scale;
  int t, d, num_rows;
  int team;            // threads per row: a power of two, at most 32
  float* out;          // (num_rows, d)
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, rowsum::kMinBlocksPerSm)
rowsparse_scatter_kernel(Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t gs = static_cast<int64_t>(gridDim.x) * kThreads;

  // 1. zero
  rowsum::zero_f32(a.out, static_cast<int64_t>(a.num_rows) * a.d, gt, gs);
  grid.sync();

  // 2. scatter, each row times its id's factor
  rowsum::add_rows<T, VEC>(static_cast<const T*>(a.rows), a.out, a.t, a.d, a.team, gt, gs,
                           [&](int64_t row, int* dst, float* f) {
                             const int v = __ldg(a.ids + row);
                             if (v < 0 || v >= a.num_rows) return;
                             *dst = v;
                             *f = rowsum::heat_factor(a.heat, v, a.total, a.scale);
                           });
}

}  // namespace

// Blocks of the kernel instance for (rows_bf16, vec) that fit on the current
// device at once, or a negated CUDA error.
extern "C" int rowsparse_scatter_max_blocks(int rows_bf16, int vec) {
  auto kernel = ROWSUM_PICK(rowsparse_scatter_kernel, rows_bf16, vec);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return rowsum::max_coresident_blocks(kernel);
}

// ids (t,) int32; rows (t, d) f32 or bf16 (rows_bf16 != 0), aligned to vec
// elements; heat (num_rows,) f32. vec (4, 2 or 1) and team as
// kernels/_rows.py plans them; blocks at most rowsparse_scatter_max_blocks.
// Output: out (num_rows, d) f32, 16-byte aligned, any contents: the kernel
// writes every element. device: the CUDA device the pointers and the stream
// belong to. Returns the launch's CUDA error, 0 if none.
extern "C" int rowsparse_scatter_launch(const void* ids, const void* rows, int rows_bf16,
                                        const void* heat, float total, float scale,
                                        int t, int d, int num_rows, int vec, int team,
                                        int blocks, void* out, int device, void* stream) {
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.rows = rows;
  a.heat = static_cast<const float*>(heat);
  a.total = total;
  a.scale = scale;
  a.t = t;
  a.d = d;
  a.num_rows = num_rows;
  a.team = team;
  a.out = static_cast<float*>(out);
  return rowsum::launch_cooperative(ROWSUM_PICK(rowsparse_scatter_kernel, rows_bf16, vec),
                                    blocks, a, device, static_cast<cudaStream_t>(stream));
}
