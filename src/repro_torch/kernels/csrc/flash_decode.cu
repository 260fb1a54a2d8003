// Single-token flash decode against a (possibly ring-buffer) KV cache, for
// Hopper (sm_90a): the attention of every decode step.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode.
// That kernel runs the grid (B*H, cache blocks) with the cache axis in order,
// carries m, l and acc in VMEM scratch, and reads each KV head's cache once
// for every one of the H/KV query heads that share it. Here:
//
//   pass 1  one block per (batch, KV head, group of up to 8 of its query
//           heads, slice of the cache). Each warp walks the slice's slots,
//           reads a slot's k and v rows once for all of the group's query
//           heads, skips slots whose position is not valid
//           (0 <= kpos <= q_position, and kpos > q_position - window when a
//           window is set: ring buffers work by position value), and keeps
//           a running max m, sum l and accumulator acc per query head in
//           registers. The block's warps merge in shared memory and write
//           (m, l, acc) for their slice.
//   pass 2  one block per (batch, query head) merges the slices by
//           log-sum-exp: M = max m_i, L = sum l_i e^(m_i - M),
//           out = sum acc_i e^(m_i - M) / L, in the inputs' dtype.
//
// This is the split-K form the TPU kernel's docstring names for its sharded
// path. Scores are q.k / sqrt(hd) in f32, as repro/models/layers.py::
// decode_attention computes them. It departs from decode_attention in two
// places, both deliberate:
//   - p stays f32 in the PV product. decode_attention rounds the normalised
//     softmax to the cache's dtype first; an online softmax never holds the
//     normalised p, and rounding its unnormalised p would be a different
//     rounding, not the same one. In bf16 the two differ by that rounding
//     (within the 2e-2 tolerance, and 1e-2 in relative norm).
//   - a (batch, head) with no valid slot gets zeros; decode_attention, whose
//     scores are then all -1e30, returns the mean of V. A decode step never
//     has such a row: it writes the token's own slot before attending.
//
// Bound on the H100: bytes. At the serving decode step (B 4, KV 8, 1,056
// slots, hd 128, bf16) the step must read the 17.3 MB of valid cache once;
// the flops are ~1e8. One block per (batch, KV head) would be 32 blocks on
// 132 SMs, so the wrapper splits the cache into slices until there are a
// few hundred blocks, and each warp loads four slots' rows before it uses
// them to keep loads in flight. Vector loads and a cp.async/TMA pipeline are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;     // query heads per block
constexpr int kUnroll = 4;   // slots loaded ahead per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool slot_valid(int kpos, int q_position, int window) {
  return kpos >= 0 && kpos <= q_position && (window <= 0 || kpos > q_position - window);
}

// part layout: (b, h, nsplit, HD + 2) f32 holding m, l, acc[HD]
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ kpos, int q_position, int window, int h, int kvh,
             int s_len, int chunk, int nsplit, float sqrt_hd, float* __restrict__ part) {
  constexpr int EPL = (HD + 31) / 32;   // elements of a row per lane
  __shared__ float sm_m[kWarps][kMaxG], sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][HD];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int gchunks = (h / kvh + kMaxG - 1) / kMaxG;
  const int kv_head = blockIdx.y / gchunks;
  const int groups = h / kvh;
  const int g0 = (blockIdx.y % gchunks) * kMaxG;
  const int ng = min(kMaxG, groups - g0);
  const int head0 = kv_head * groups + g0;   // first query head of the block

  float qr[kMaxG][EPL], acc[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane * EPL + e;
      acc[g][e] = 0.f;
      qr[g][e] = (g < ng && d < HD)
          ? to_f32(q[(static_cast<int64_t>(b) * h + head0 + g) * HD + d]) : 0.f;
    }
  }

  const int64_t base = (static_cast<int64_t>(b) * kvh + kv_head) * s_len;
  const int s_begin = split * chunk, s_end = min(s_len, s_begin + chunk);
  for (int s0 = s_begin + warp * kUnroll; s0 < s_end; s0 += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      ok[u] = s < s_end && slot_valid(kpos[s], q_position, window);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane * EPL + e;
        const bool load = ok[u] && d < HD;
        kr[u][e] = load ? to_f32(kc[(base + s) * HD + d]) : 0.f;
        vr[u][e] = load ? to_f32(vc[(base + s) * HD + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;   // warp-uniform: every lane sees the same slot
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= ng) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float sc = dot / sqrt_hd;
        const float m_new = fmaxf(m[g], sc);
        const float corr = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * corr + p;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e] * corr);
      }
    }
  }

  // merge the warps of the block
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane * EPL + e;
      if (d < HD) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();
  const int64_t stride = HD + 2;
  for (int i = threadIdx.x; i < ng * (HD + 2); i += kThreads) {
    const int g = i / (HD + 2), c = i % (HD + 2);
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float val = 0.f;
    if (c == 0) {
      val = mx;
    } else if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm_m[w][g] - mx);
        val += f * (c == 1 ? sm_l[w][g] : sm_acc[w][g][c - 2]);
      }
    }
    part[((static_cast<int64_t>(b) * h + head0 + g) * nsplit + split) * stride + c] = val;
  }
}

template <typename T, int HD>
__global__ void merge_kernel(const float* __restrict__ part, int nsplit,
                             T* __restrict__ out) {
  const int bh = blockIdx.x;   // b * h + head
  const int64_t stride = HD + 2;
  const float* pp = part + static_cast<int64_t>(bh) * nsplit * stride;
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, pp[i * stride]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int i = 0; i < nsplit; ++i) {
        const float f = expf(pp[i * stride] - mx);
        l += f * pp[i * stride + 1];
        a += f * pp[i * stride + 2 + d];
      }
    }
    store(out + static_cast<int64_t>(bh) * HD + d, l > 0.f ? a / l : 0.f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const int* kpos, int b,
           int h, int kvh, int s_len, int q_position, int window, int nsplit,
           int chunk, float sqrt_hd, float* part, void* out, cudaStream_t stream) {
  const int gchunks = (h / kvh + kMaxG - 1) / kMaxG;
  split_kernel<T, HD><<<dim3(nsplit, kvh * gchunks, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      kpos, q_position, window, h, kvh, s_len, chunk, nsplit, sqrt_hd, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<T, HD><<<b * h, HD < 32 ? 32 : HD, 0, stream>>>(part, nsplit,
                                                              static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* kc, const void* vc, const int* kpos,
             int b, int h, int kvh, int s_len, int q_position, int window, int nsplit,
             int chunk, float sqrt_hd, float* part, void* out, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, s);
    case 32: return launch<T, 32>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, s);
    case 64: return launch<T, 64>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, s);
    case 128: return launch<T, 128>(q, kc, vc, kpos, b, h, kvh, s_len, q_position, window, nsplit, chunk, sqrt_hd, part, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out (b, h, hd); k_cache, v_cache (b, kvh, s_len, hd); all contiguous, f32
// or bf16 (is_bf16 != 0); k_positions (s_len,) int32, -1 for an empty slot; h
// a multiple of kvh; hd in {16, 32, 64, 128}. The cache is cut into nsplit
// slices of chunk slots; part is f32 scratch of b * h * nsplit * (hd + 2).
// window <= 0 means no window. Returns the CUDA error of the launches.
extern "C" int flash_decode_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_positions,
                                   int is_bf16, int b, int h, int kvh, int s_len,
                                   int hd, int q_position, int window, int nsplit,
                                   int chunk, float sqrt_hd, void* part, void* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kpos = static_cast<const int*>(k_positions);
  float* pp = static_cast<float*>(part);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k_cache, v_cache, kpos, b, h, kvh, s_len,
                                   q_position, window, nsplit, chunk, sqrt_hd, pp,
                                   out, s);
  return dispatch<float>(hd, q, k_cache, v_cache, kpos, b, h, kvh, s_len, q_position,
                         window, nsplit, chunk, sqrt_hd, pp, out, s);
}
