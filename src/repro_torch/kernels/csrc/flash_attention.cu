// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a). Forward only: the serving path's prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention.
// That kernel runs the grid (B*H, q blocks, k blocks) with the k-block axis in
// order and carries the running max m, sum l and accumulator acc in VMEM
// scratch from one grid step to the next. A GPU grid has no order, so here
// one block owns one (batch, head, 64-row query tile) and walks the key tiles
// itself, keeping m, l and acc in registers:
//
//   load the Q tile (64 x hd) into shared memory, converted to f32
//   for each 64-key tile between the window's lower edge and the causal
//   diagonal (tiles that are masked for every row are never read):
//     S = Q K^T * scale (f32), masked where kpos >= Sk, kpos > qpos (causal)
//         or kpos <= qpos - window
//     m' = max(m, rowmax S); p = exp(S - m'); corr = exp(m - m')
//     l = l * corr + rowsum p; acc = acc * corr + p V
//   out = acc / max(l, 1e-30), in the inputs' dtype
//
// The online-softmax update and the masked value -1e30 are the reference's
// own (repro/models/layers.py::_chunk_scan), so a tile in which a row has no
// valid key yet is wiped by the next correction exactly as there; with bf16
// inputs p is rounded to bf16 before the PV product, as the reference does.
// Query head h reads KV head h / (H / KV) through the pointer arithmetic: K
// and V are never repeated. Ragged Sq and Sk are masked in the kernel (the
// TPU kernel asserts block-aligned lengths).
//
// Bound on the H100: operations. At the serving prefill (B 4, S 1024, H 40,
// KV 8, hd 128, bf16, causal) the product needs ~4.3e10 flops against ~101 MB
// of q, k, v and o. This first version does its products as f32 FMAs on the
// CUDA cores (no tensor cores, so f32 inputs keep full f32 accuracy): each of
// the 256 threads owns a 4 x 4 block of S and a 4 x (hd/16) block of acc,
// shared-memory rows are padded by one word against bank conflicts, and K
// and V take turns in one buffer so that two blocks fit on an SM. Moving the
// products to wgmma with TMA-fed tiles is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty picks rows, tx columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p in the dtype of V, as the reference's p.astype(v.dtype)
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                       int h, int kvh, float scale, int causal, int window,
                       int q_offset) {
  constexpr int QS = HD + 1;   // padded row stride of the Q and K/V tiles
  constexpr int PS = kBK + 1;  // padded row stride of the P tile
  constexpr int DJ = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // kBQ x QS
  float* kvs = qs + kBQ * QS;     // kBK x QS: K, then V, of the current tile
  float* ps = kvs + kBK * QS;     // kBQ x PS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = static_cast<int64_t>(h) * HD;     // stride between positions
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;
  T* ob = o + (static_cast<int64_t>(b) * sq * h + head) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    qs[r * QS + d] = s < sq ? to_f32(qb[s * q_row + d]) : 0.f;
  }

  // key tiles this block needs: up to the causal diagonal of its last real
  // row, from the window's lower edge of its first row
  const int nk = (sk + kBK - 1) / kBK;
  int kt_end = nk;
  if (causal) {
    const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
    kt_end = min(nk, q_last / kBK + 1);
  }
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    kt_begin = lo > 0 ? lo / kBK : 0;
  }

  float m[4], l[4], acc[4][DJ];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q_offset + q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's V and P reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      kvs[r * QS + d] = s < sk ? to_f32(kb[s * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos[i];
        if (window > 0) ok = ok && kpos > qpos[i] - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = round_like(p, vb);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }

    __syncthreads();  // every K read is done: V takes the buffer
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s2 = k0 + r;
      kvs[r * QS + d] = s2 < sk ? to_f32(vb[s2 * k_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kvs[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + s * q_row + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
           int sk, int h, int kvh, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, h, kvh, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kvh, float scale, int causal, int window,
             int q_offset, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, kvh, scale, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, kvh, scale, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, kvh, scale, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, kvh, scale, causal, window, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o (b, sq, h, hd); k, v (b, sk, kvh, hd); all contiguous, f32 or bf16
// (is_bf16 != 0), h a multiple of kvh, hd in {16, 32, 64, 128}. Query row i
// sits at position q_offset + i, key j at position j. window <= 0 means no
// window. Returns the CUDA error of the launch, 0 if none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int is_bf16, int b, int sq, int sk,
                                      int h, int kvh, int hd, float scale,
                                      int causal, int window, int q_offset,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, b, sq, sk, h, kvh, scale, causal,
                                   window, q_offset, s);
  return dispatch<float>(hd, q, k, v, o, b, sq, sk, h, kvh, scale, causal, window,
                         q_offset, s);
}
