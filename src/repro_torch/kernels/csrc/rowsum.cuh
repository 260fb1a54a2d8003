// Row-wise pieces shared by K1 (union_segsum.cu) and K2 (rowsparse_scatter.cu):
// a row read in loads of VEC elements and added into an f32 row with vector
// atomics, a zero fill in 16-byte stores, the FedSubAvg factor, and the
// occupancy query and cooperative launch of a one-launch kernel.
//
// A row of d elements is served by a team of `team` threads (a power of two,
// at most a warp; kernels/_rows.py:team_size): each row's id, destination and
// factor are worked out once, by one lane, and shuffled to the team, whose
// lanes move VEC elements at a time. VEC is 4 or 2 where d and the rows'
// address allow it (kernels/_rows.py:vector_width), else 1. atomicAdd on
// float2 and float4 exists for global memory from sm_90 on.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace rowsum {

constexpr int kThreads = 512;  // threads per block (THREADS in kernels/_rows.py)
constexpr int kMinBlocksPerSm = 2;

// VEC consecutive elements of a row as f32, in one load of VEC * sizeof(T)
// bytes that skips L1 (each row is read once)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&x)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (VEC == 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else if constexpr (VEC == 2) {
      const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
      x[0] = v.x; x[1] = v.y;
    } else {
      x[0] = __ldcs(p);
    }
  } else {
    if constexpr (VEC == 4) {
      const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
      __nv_bfloat162 lo, hi;
      memcpy(&lo, &raw.x, 4);
      memcpy(&hi, &raw.y, 4);
      const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
      x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    } else if constexpr (VEC == 2) {
      const unsigned raw = __ldcs(reinterpret_cast<const unsigned*>(p));
      __nv_bfloat162 h;
      memcpy(&h, &raw, 4);
      const float2 a = __bfloat1622float2(h);
      x[0] = a.x; x[1] = a.y;
    } else {
      x[0] = __bfloat162float(p[0]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void add_row(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    atomicAdd(p, x[0]);
  }
}

// The lanes of this thread's team within its warp, for __shfl_sync.
__device__ __forceinline__ unsigned team_mask(int team) {
  if (team == 32) return 0xffffffffu;
  const int first = (threadIdx.x & 31) & ~(team - 1);
  return ((1u << team) - 1u) << first;
}

// Rows whose loads are in flight before their atomic adds: kGroup float2
// loads per lane, or half as many float4 loads in the same registers.
constexpr int kGroup = 8;

// out[dst(t)] += f(t) * rows[t] for every row t in [0, t_count), by the
// whole grid. Each team takes `team` consecutive rows at a time: lane i
// resolves row base + i (resolve(t, &dst, &f): the destination row, or -1
// to drop the row, and the factor), so the team's dependent loads (id, then
// what the id indexes) run for `team` rows at once. The team then adds the
// resolved rows G at a time, their destinations and factors shuffled
// from the lanes that resolved them: the loads of a group are issued before
// its atomics, so a lane waits for one load latency per group, not per row.
template <typename T, int VEC, typename Resolve>
__device__ __forceinline__ void add_rows(const T* rows, float* out, int64_t t_count, int d,
                                         int team, int64_t gt, int64_t gs,
                                         Resolve resolve) {
  constexpr int G = VEC == 4 ? kGroup / 2 : kGroup;
  const int lane = threadIdx.x & (team - 1);
  const unsigned mask = team_mask(team);
  for (int64_t base = gt - lane; base < t_count; base += gs) {
    int dst = -1;
    float f = 0.f;
    if (base + lane < t_count) resolve(base + lane, &dst, &f);
    for (int i0 = 0; i0 < team; i0 += G) {
      int dg[G];
      float fg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dg[g] = __shfl_sync(mask, dst, (i0 + g) & (team - 1), team);
        fg[g] = __shfl_sync(mask, f, (i0 + g) & (team - 1), team);
        if (i0 + g >= team) dg[g] = -1;
      }
      for (int j = lane * VEC; j < d; j += team * VEC) {
        float x[G][VEC];
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (dg[g] >= 0) load_row<T, VEC>(rows + (base + i0 + g) * d + j, x[g]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (dg[g] < 0) continue;
#pragma unroll
          for (int k = 0; k < VEC; ++k) x[g][k] *= fg[g];
          add_row<VEC>(out + static_cast<int64_t>(dg[g]) * d + j, x[g]);
        }
      }
    }
  }
}

// (total / max(heat[v], 1)) * scale, 0 where heat is 0; scale alone without
// heat. The reference's order: divide, then scale.
__device__ __forceinline__ float heat_factor(const float* heat, int v, float total,
                                             float scale) {
  if (heat == nullptr) return scale;
  const float h = __ldg(heat + v);
  return h > 0.f ? (total / fmaxf(h, 1.f)) * scale : 0.f;
}

// p[0:n] = 0 by the whole grid, 16 bytes a store (p is 16-byte aligned)
__device__ __forceinline__ void zero_f32(float* p, int64_t n, int64_t gt, int64_t gs) {
  const int64_t n4 = n >> 2;
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int64_t i = gt; i < n4; i += gs) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t i = (n4 << 2) + gt; i < n; i += gs) p[i] = 0.f;
}

// Blocks of kThreads that can be resident on the current device at once: the
// most a cooperative launch of `kernel` may ask for. A CUDA error comes back
// negated.
template <typename Kernel>
int max_coresident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  cudaGetLastError();
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

// One cooperative launch of `kernel(args)` on `blocks` blocks, on `device`
// (made current for the launch and the caller's restored after it, as a
// device guard does). The runtime refuses a grid that cannot be resident at
// once; the error is returned (and cleared, so that it does not surface at a
// later launch).
template <typename Kernel, typename Args>
int launch_cooperative(Kernel kernel, int blocks, Args args, int device, cudaStream_t s) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    void* params[] = {&args};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kThreads), params, 0, s);
    if (prev != device) cudaSetDevice(prev);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace rowsum

// The instance of the kernel template KERNEL<T, VEC> for the rows' type and
// VEC, or null for another VEC (a __global__ function cannot be a class
// member, so this is a macro).
#define ROWSUM_PICK(KERNEL, rows_bf16, vec)                                         \
  ((rows_bf16) ? ((vec) == 4   ? &KERNEL<__nv_bfloat16, 4>                          \
                  : (vec) == 2 ? &KERNEL<__nv_bfloat16, 2>                          \
                  : (vec) == 1 ? &KERNEL<__nv_bfloat16, 1>                          \
                               : nullptr)                                           \
               : ((vec) == 4   ? &KERNEL<float, 4>                                  \
                  : (vec) == 2 ? &KERNEL<float, 2>                                  \
                  : (vec) == 1 ? &KERNEL<float, 1>                                  \
                               : nullptr))
