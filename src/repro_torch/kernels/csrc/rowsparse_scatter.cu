// Fused scatter-add + FedSubAvg correction into a dense (V, D) table, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/heat_scatter.py:rowsparse_scatter
// (heat_scatter is its scale = 1 case). The TPU kernel accumulates a blocked
// one-hot matmul per (vocab block, row block) on the MXU, because the TPU has
// no scatter; the GPU has atomics, as that module's own docstring says:
//
//   1. scatter every valid element t of the rows atomically adds its f32
//              value into out[ids[t]] (ids outside [0, V) are dropped); the
//              wrapper hands in a zeroed output
//   2. scale   out[v] = (out[v] * (total / max(heat[v], 1))) * scale, 0 where
//              heat is 0 (the order of kernels/ref.py's rowsparse_scatter_ref)
//
// Bound on the H100: bytes. It reads the ids (4T) and rows (T*D of f32 or
// bf16) once, and writes the dense output (4*V*D) once after zeroing it;
// the scale pass reads heat (4V) and the output again. The output dominates
// at every shape the module is used at, so the kernel streams it with
// coalesced grid-stride loops and does one add and two multiplies per element.
//
// The atomics make the f32 sum order vary from run to run, so results agree
// with the plain PyTorch version to a tolerance and not bit for bit.
// total and scale are kernel arguments, never compile-time constants.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void scatter_kernel(const int* __restrict__ ids,
                               const T* __restrict__ rows, int t, int d,
                               int num_rows, float* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(t) * d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / d;
    const int v = ids[row];
    if (v < 0 || v >= num_rows) continue;
    atomicAdd(out + static_cast<int64_t>(v) * d + (i - row * d), to_f32(rows[i]));
  }
}

__global__ void scale_kernel(const float* __restrict__ heat, float total,
                             float scale, int num_rows, int d,
                             float* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(num_rows) * d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float h = heat[i / d];
    const float f = h > 0.f ? total / fmaxf(h, 1.f) : 0.f;
    out[i] = (out[i] * f) * scale;
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

}  // namespace

// ids (t,) int32; rows (t, d) f32 or bf16 (rows_bf16 != 0); heat (num_rows,)
// f32. Output: out (num_rows, d) f32, zeroed by the caller. Returns the CUDA
// error of the launches, 0 if none.
extern "C" int rowsparse_scatter_launch(const void* ids, const void* rows,
                                        int rows_bf16, const void* heat,
                                        float total, float scale, int t, int d,
                                        int num_rows, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids_p = static_cast<const int*>(ids);
  float* out_p = static_cast<float*>(out);
  const int64_t n = static_cast<int64_t>(t) * d;
  if (rows_bf16) {
    scatter_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        ids_p, static_cast<const __nv_bfloat16*>(rows), t, d, num_rows, out_p);
  } else {
    scatter_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        ids_p, static_cast<const float*>(rows), t, d, num_rows, out_p);
  }
  scale_kernel<<<blocks_for(static_cast<int64_t>(num_rows) * d), kThreads, 0, s>>>(
      static_cast<const float*>(heat), total, scale, num_rows, d, out_p);
  return static_cast<int>(cudaGetLastError());
}
