// The gradient of K3: dq, dk and dv of causal GQA flash attention with an
// optional sliding window, for Hopper (sm_90a), on the CUDA cores.
//
// Replaces what the TPU path gets from autodiff: the JAX package has no
// backward Pallas kernel, and differentiates src/repro/models/layers.py::
// mea_attention (jax.checkpoint per query chunk, so the backward recomputes
// each chunk's scores) through XLA. Here the function K3 computes
// (src/repro_torch/kernels/csrc/flash_attention.cu, whose TPU kernel is
// src/repro/kernels/flash_attention.py:flash_attention) is differentiated by
// hand. With s = q k^T * scale masked where kpos >= Sk, kpos > qpos (causal)
// or kpos <= qpos - window, P = softmax over the valid keys, o = P v:
//
//   D_i   = rowsum(dO_i * O_i)
//   dV_j  = sum_i P_ij dO_i                       (over the group's heads)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = scale * sum_j dS_ij k_j
//   dK_j  = scale * sum_i dS_ij q_i               (over the group's heads)
//
// P is never stored: both kernels recompute it from the row statistics, so
// K3's forward stays as it is and emits nothing extra. Two launches:
//
//   dq_kernel, one block per (query tile of 64 rows, head, batch): a first
//   walk over the key tiles between the window's lower edge and the causal
//   diagonal recomputes each row's max m and sum l of exp(s - m) over its
//   valid keys; D comes from O and dO. m, l and D go to a scratch buffer.
//   A second walk forms P, dP = dO V^T and dS, and accumulates dQ.
//
//   dkv_kernel, one block per (key tile of 64 keys, KV head, batch): walks
//   the query tiles that can see its keys, for each query head of its GQA
//   group in turn, reads m, l and D, and accumulates dK and dV in
//   registers. One block owns each dK and dV row, so the group's heads are
//   summed without atomics and the result is the same from run to run.
//
// A row with no valid key gets P = 0 (l = 0): no gradient flows through it.
// The forward gives such a row the mean of V over its masked keys, a value
// no causal training batch produces (key 0 is valid for every query at
// q_offset >= 0 without a window).
//
// Bound on the H100: operations. The gradient needs five products per valid
// (query, key) pair (S again, dP, dV, dQ, dK), 2.5x the forward's flops: at
// the training shape (B 16, S 128, H 40, KV 8, hd 128, causal, f32) 6.8e9
// flops, 0.101 ms at the 67 TFLOP/s f32 rate, against 201 MB of q, k, v, o,
// dO and the three gradients, 0.060 ms at 3.35 TB/s. This kernel makes eight
// products per pair (S in both launches, dP in both). This first design is
// simple and right, not fast: f32 FMAs on the CUDA cores for f32 and bf16
// inputs alike (bf16 is widened to f32 as it is loaded into shared memory,
// and every sum is f32), 256 threads as 16 x 16, each owning a 4 x 4 block
// of a 64 x 64 score tile and a 4 x (hd/16) block of its accumulator;
// shared-memory rows padded by one word against bank conflicts. wgmma is
// later work (the forward's bf16 kernel shows the layout).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx columns
constexpr int kPS = kTile + 1;   // padded row stride of the score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool is_valid(int kpos, int qpos, int sk, int causal,
                                         int window) {
  bool ok = kpos < sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// rows [row0, row0 + 64) of one head of a (batch, seq, heads, HD) tensor into
// a padded f32 tile; rows past `limit` are zero
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row_stride, int row0, int limit) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = row0 + r;
    dst[r * (HD + 1) + d] = s < limit ? to_f32(src[s * row_stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two padded tiles
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int S = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * S + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * S + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  return 4 * kTile * (HD + 1) + kTile * kPS + kTile;
}

template <int HD>
constexpr int dkv_smem_floats() {
  return 4 * kTile * (HD + 1) + kTile * kPS + 3 * kTile;
}

// ---------------------------------------------------------------------------
// row statistics and dQ
// ---------------------------------------------------------------------------

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ stats, int b_count, int sq, int sk, int h, int kvh,
          float scale, int causal, int window, int q_offset) {
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                 // kTile x S
  float* dos = qs + kTile * S;      // kTile x S
  float* ks = dos + kTile * S;      // kTile x S
  float* vs = ks + kTile * S;       // kTile x S
  float* ps = vs + kTile * S;       // kTile x kPS: dS of the current tile
  float* ds_row = ps + kTile * kPS; // kTile: D

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = static_cast<int64_t>(h) * HD;
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const int64_t q_base = (static_cast<int64_t>(b) * sq * h + head) * HD;
  const int64_t k_base = (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;
  const int64_t n_rows = static_cast<int64_t>(b_count) * h * sq;
  const int64_t stat_base = (static_cast<int64_t>(b) * h + head) * sq;

  load_tile<HD>(qs, q + q_base, q_row, q0, sq);
  load_tile<HD>(dos, dout + q_base, q_row, q0, sq);
  {
    // D: four threads per row, each a quarter of the head dim
    const int r = tid / 4, part = tid % 4, s = q0 + r;
    float acc = 0.f;
    if (s < sq) {
      const T* orow = o + q_base + s * q_row;
      const T* dorow = dout + q_base + s * q_row;
      for (int d = part; d < HD; d += 4) acc = fmaf(to_f32(orow[d]), to_f32(dorow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) ds_row[r] = acc;
  }

  const int nk = (sk + kTile - 1) / kTile;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q_offset + min(q0 + kTile, sq) - 1) / kTile + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    kt_begin = lo > 0 ? lo / kTile : 0;
  }

  int qpos[4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q_offset + q0 + ty + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  // first walk: each row's max and sum over its valid keys
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<HD>(ks, k + k_base, k_row, k0, sk);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = is_valid(k0 + tx + 16 * j, qpos[i], sk, causal, window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += is_valid(k0 + tx + 16 * j, qpos[i], sk, causal, window)
                   ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  __syncthreads();  // D is in shared memory
  float inv_l[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    inv_l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    drow[i] = ds_row[r];
    if (tx == 0 && q0 + r < sq) {
      stats[stat_base + q0 + r] = m[i];
      stats[n_rows + stat_base + q0 + r] = inv_l[i];
      stats[2 * n_rows + stat_base + q0 + r] = drow[i];
    }
  }

  // second walk: P, dP = dO V^T, dS = P (dP - D), dQ += dS K
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<HD>(ks, k + k_base, k_row, k0, sk);
    load_tile<HD>(vs, v + k_base, k_row, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, qs, ks, ty, tx);
    tile_dot<HD>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = is_valid(k0 + tx + 16 * j, qpos[i], sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - m[i]) * inv_l[i] : 0.f;
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - drow[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[q_base + s * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ stats, int b_count, int sq, int sk, int h, int kvh,
           float scale, int causal, int window, int q_offset) {
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;                 // kTile x S
  float* vs = ks + kTile * S;       // kTile x S
  float* qs = vs + kTile * S;       // kTile x S
  float* dos = qs + kTile * S;      // kTile x S
  float* ps = dos + kTile * S;      // kTile x kPS: P, then dS, [query][key]
  float* m_s = ps + kTile * kPS;    // kTile each: m, 1 / l, D of the query rows
  float* il_s = m_s + kTile;
  float* d_s = il_s + kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTile, kv_head = blockIdx.y, b = blockIdx.z;
  const int groups = h / kvh;
  const int64_t q_row = static_cast<int64_t>(h) * HD;
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const int64_t k_base = (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;
  const int64_t n_rows = static_cast<int64_t>(b_count) * h * sq;

  load_tile<HD>(ks, k + k_base, k_row, k0, sk);
  load_tile<HD>(vs, v + k_base, k_row, k0, sk);

  // the query tiles that can see a key of this tile
  const int nq = (sq + kTile - 1) / kTile;
  int qt_begin = 0;
  if (causal) {
    const int first = k0 - q_offset;
    qt_begin = first > 0 ? first / kTile : 0;
  }
  int qt_end = nq;
  if (window > 0) {
    const int last = min(k0 + kTile, sk) - 1 + window - 1 - q_offset;
    qt_end = last < 0 ? 0 : min(nq, last / kTile + 1);
  }

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int head = kv_head * groups + g;
    const int64_t q_base = (static_cast<int64_t>(b) * sq * h + head) * HD;
    const int64_t stat_base = (static_cast<int64_t>(b) * h + head) * sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's reads are done
      load_tile<HD>(qs, q + q_base, q_row, q0, sq);
      load_tile<HD>(dos, dout + q_base, q_row, q0, sq);
      if (tid < kTile) {
        const bool in = q0 + tid < sq;
        m_s[tid] = in ? stats[stat_base + q0 + tid] : 0.f;
        il_s[tid] = in ? stats[n_rows + stat_base + q0 + tid] : 0.f;  // 1 / l = 0: P = 0
        d_s[tid] = in ? stats[2 * n_rows + stat_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<HD>(s, qs, ks, ty, tx);     // [query ty + 16 i][key tx + 16 j]
      tile_dot<HD>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q_offset + q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = is_valid(k0 + tx + 16 * j, qpos, sk, causal, window);
          const float p = ok ? expf(s[i][j] * scale - m_s[r]) * il_s[r] : 0.f;
          ps[r * kPS + tx + 16 * j] = p;
          dp[i][j] = p * (dp[i][j] - d_s[r]);   // dS
        }
      }
      __syncthreads();
      // dV[key ty + 16 i][d tx + 16 j] += sum_r P[r][key] dO[r][d]
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], dov[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[r * kPS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dov[j] = dos[r * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPS + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK[key][d] += sum_r dS[r][key] Q[r][d]
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float dsv[4], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = ps[r * kPS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qv[j] = qs[r * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int64_t at = k_base + s * k_row + tx + 16 * j;
      dk[at] = from_f32<T>(dk_acc[i][j] * scale);
      dv[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int b, int sq, int sk, int h,
           int kvh, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  float* st = static_cast<float*>(stats);
  constexpr int dq_bytes = dq_smem_floats<HD>() * sizeof(float);
  constexpr int dkv_bytes = dkv_smem_floats<HD>() * sizeof(float);
  auto k_dq = dq_kernel<HD, T>;
  auto k_dkv = dkv_kernel<HD, T>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(k_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sq + kTile - 1) / kTile, h, b);
  k_dq<<<grid_q, kThreads, dq_bytes, stream>>>(qp, kp, vp, static_cast<const T*>(o), dop,
                                               static_cast<T*>(dq), st, b, sq, sk, h, kvh,
                                               scale, causal, window, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k((sk + kTile - 1) / kTile, kvh, b);
  k_dkv<<<grid_k, kThreads, dkv_bytes, stream>>>(qp, kp, vp, dop, static_cast<T*>(dk),
                                                 static_cast<T*>(dv), st, b, sq, sk, h,
                                                 kvh, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                       void*, void*, void*, void*, int, int, int, int, int, float, int,
                       int, int, cudaStream_t);

template <typename T>
Launch pick(int hd) {
  switch (hd) {
    case 16: return launch<16, T>;
    case 32: return launch<32, T>;
    case 64: return launch<64, T>;
    case 128: return launch<128, T>;
    default: return nullptr;
  }
}

}  // namespace

// q, o, dout, dq (b, sq, h, hd); k, v, dk, dv (b, sk, kvh, hd); all contiguous
// and of one dtype, h a multiple of kvh, hd in {16, 32, 64, 128}; stats f32
// scratch of 3 * b * h * sq. Query row i sits at position q_offset + i, key j
// at position j; window <= 0 means no window. Each returns the CUDA error of
// its launches, 0 if none.

extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, void* dq,
                                              void* dk, void* dv, void* stats, int b,
                                              int sq, int sk, int h, int kvh, int hd,
                                              float scale, int causal, int window,
                                              int q_offset, void* stream) {
  Launch fn = pick<float>(hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, dq, dk, dv, stats, b, sq, sk, h, kvh, scale, causal, window,
            q_offset, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, void* dq,
                                               void* dk, void* dv, void* stats, int b,
                                               int sq, int sk, int h, int kvh, int hd,
                                               float scale, int causal, int window,
                                               int q_offset, void* stream) {
  Launch fn = pick<__nv_bfloat16>(hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, dout, dq, dk, dv, stats, b, sq, sk, h, kvh, scale, causal, window,
            q_offset, static_cast<cudaStream_t>(stream));
}
