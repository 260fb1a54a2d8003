// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a). Forward only: the serving path's prefill and the training
// forward, which also asks for each row's log-sum-exp (lse = m + log l, +inf
// on a row with no valid key) for K3's backward (csrc/flash_attention_bwd.cu);
// the serving path passes no lse pointer and writes none.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention.
// That kernel runs the grid (B*H, q blocks, k blocks) with the k-block axis in
// order and carries the running max m, sum l and accumulator acc in VMEM
// scratch from one grid step to the next. A GPU grid has no order, so here
// one block owns one (batch, head, query tile) and walks the key tiles
// itself, keeping m, l and acc in registers:
//
//   for each key tile between the window's lower edge and the causal
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
// Query head h reads KV head h / (H / KV): K and V are never repeated.
// Ragged Sq and Sk are masked in the kernel (the TPU kernel asserts
// block-aligned lengths).
//
// Bound on the H100: operations. At the serving prefill (B 4, S 1024, H 40,
// KV 8, hd 128, bf16, causal) the two products need ~4.3e10 flops against
// ~101 MB of q, k, v and o: 0.044 ms at the 989 TFLOP/s bf16 tensor-core
// rate. The launcher dispatches by dtype to one of two kernels, both on the
// tensor cores:
//
// bf16: tensor cores (attention_kernel). A work item is one (query head,
// batch, 128-row query tile), numbered with the longest causal tiles first.
// The grid is persistent, one block of three warpgroups per SM walking items
// with a stride of the grid, so that the loads of a block's next item run
// under the end of its current one (a block per item left each block's
// first loads and last stores bare). Warpgroup 0 is the producer: it gives
// up registers (setmaxnreg 24) and one thread issues TMA loads: Q into one
// of two buffers per item, K and V tiles of 128 keys into two-stage rings in
// shared memory, each guarded by mbarriers (full: bytes arrived; empty: both
// consumers are done; K's stage is freed as soon as its S product is, V's
// after its PV product). Warpgroups 1 and 2 take 240 registers each and own
// 64 query rows apiece: S = Q K^T is hd/16 wgmma.m64n128k16 with both
// operands in shared memory; the softmax runs on the f32 accumulator
// fragment; p is rounded to bf16 in registers and fed as the A operand of
// hd-wide wgmmas (m64n{hd}k16) with V from shared memory. The exponentials
// and the rest of the softmax would otherwise leave the tensor cores idle,
// so they overlap the products twice over: within a warpgroup, the PV
// product of tile i-1 runs while the softmax of tile i does (the S product
// of tile i is issued just before it), and between the two warpgroups,
// named barriers make them take turns to issue, so one's softmax can run
// under the other's products. Masks are computed only on tiles that cross
// the diagonal, the window edge or Sk. At hd 128 shared memory holds 2 x 32
// KB of Q and 2 x 2 x 32 KB of K and V (193 KB of the 227).
// Where the trouble lies, and what handles it:
//   1. TMA descriptors (flash_attention_bf16_launch): cuTensorMapEncodeTiled
//      lives in libcuda (linked with -lcuda). One rank-4 map (hd, heads, S, B)
//      per tensor per call, since the pointers change per layer, passed as
//      __grid_constant__ CUtensorMap. A box is (min(hd, 64), 1, 128, 1): under
//      the 128-byte swizzle a box row is at most 128 bytes, so hd 128 takes
//      two boxes per tile (hd 32 and 16 use the 64- and 32-byte swizzles of
//      their row widths). TMA zero-fills rows past S; the position masks
//      still decide validity.
//   2. wgmma descriptors under the swizzle (smem_desc): the layout is the
//      one TMA wrote, rows of `kSwizzle` bytes, 8-row groups kSwizzle * 8
//      apart (SBO). A k-step of 16 elements inside a swizzle atom moves the
//      start address by 32 bytes; the next 64-column box is a whole
//      (rows x 128 B) block further on. Buffers are 1024-byte aligned.
//   3. V as the B operand (pv step): V is [key][d], N contiguous, so it is
//      MN-major; the wgmma's transpose-B flag reads it as it lies. Its LBO is
//      the stride between 64-column boxes, its SBO the stride of 8 keys.
//   4. P from registers: the f32 accumulator of the S product, packed pair
//      by pair into bf16x2, is the A-register fragment of the PV product
//      (registers 8j..8j+7 of S are the four A registers of k-step j).
//   5. Registers: a consumer thread holds S (64 f32), O (hd/2 f32) and the
//      previous tile's P (32 bf16x2) at once; the build's -Xptxas -v lines
//      report spills. The P registers feed a wgmma that runs after the
//      instruction that issued it, so they are fenced (fence_regs) until the
//      wgmma_wait that ends it, lest the compiler reuse them.
//
// f32: tensor cores by the 3xTF32 split (attention_kernel_f32). One TF32
// product keeps about three decimal digits, short of the 2e-5 that f32 is
// held to; three of them on each operand's big and small halves, in
// warp_mma.cuh's Tf32x3 policy (K3's backward's), hold it. At Whisper's
// encoder training shape (B 8, 1,500 x 1,500, H 20, hd 64, f32,
// non-causal) the two products are 9.2e10 flops, 3 TF32 products each:
// 0.559 ms at the 495 TFLOP/s TF32 rate against 0.073 ms for its 246 MB:
// bound by operations (1.376 ms on the f32 CUDA cores). A work item is one
// (64 query rows, head, batch), a block of 4 warps of 16 rows each, items
// numbered with the longest causal walks first over every head and batch.
// The design, point by point:
//   1. Products. S = Q K^T and O += P V are mma.sync.m16n8k8 TF32 on the
//      big/small halves (small*big + big*small + big*big), each chain of
//      kChain k-steps from a fresh accumulator folded in by an f32 add,
//      since the tensor cores truncate as they accumulate. S takes its terms
//      in dq_kernel's order (qk_scores), so the forward's scores, hence its
//      log-sum-exp, are the backward's bit for bit. P stays in registers as
//      the A operand of the PV product, split too (it lies in [0, 1]), its
//      contraction index permuted as the backward's dQ product's
//      (Tf32x3::a_from_acc; load_b_kn reads V's rows to match). wgmma takes
//      TF32 only with both operands K-major, and V is MN-major: not used.
//   2. Loads. K and V tiles stream through a two-stage cp.async ring with
//      zero-fill past Sk; tile i + 1's copies are in flight while tile i is
//      multiplied (one barrier a tile). Q is split once when it lands (big
//      in place, small beside it). K and V stay f32 in the ring, and each
//      warp splits the fragments it loads: split once for the block in
//      shared memory, they cost two more passes over the tile and twice the
//      bytes per fragment, and a build that did so was slower at every
//      Whisper, Zamba2 and Qwen shape it was timed at; the shared memory
//      that split took holds Q's halves at hd 128 instead.
//   3. Occupancy. Shared memory per block (F32Tile): Q's halves and the
//      ring, 16-key tiles at hd 128 (101,376 B), 32-key tiles below (69,632
//      B at hd 64): two blocks (8 warps) an SM. Registers and spills: ptxas
//      -v, printed by the build.
//   4. Work. Key tiles before the window's lower edge of the block's first
//      row or past the diagonal of its last are never read; a warp skips a
//      tile none of its pairs needs, and builds masks only on tiles that
//      cross the diagonal, the window edge or Sk. A row whose first tiles are
//      all masked keeps m at -1e30 (p = 1 on those keys) until a valid key's
//      correction wipes them, as in the reference; a skipped tile is such a
//      tile, wiped the same way, so skipping changes no valid row's result.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "introspect.cuh"
#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr float kNegInf = -1e30f;

// a row's log-sum-exp from its running max m and sum l; +inf where the row
// met no valid key (m never left the mask value), so that exp(s - lse) = 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > kNegInf ? m + logf(l) : INFINITY;
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;              // query rows per block, 64 per consumer
constexpr int kBN = 128;              // keys per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kTurn0 = 1, kTurn1 = 2; // named barriers: whose turn to issue wgmmas
constexpr int kThreads = 384;         // producer warpgroup + two consumers
constexpr int kConsumerThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kSwizzle = HD * 2 >= 128 ? 128 : HD * 2;  // bytes per row
  static constexpr int kBox = kSwizzle / 2;                        // elements per box row
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kTiles = 2 * kQBytes + 2 * kStages * kKVBytes;
  // tiles, 1024 bytes of alignment slack, the mbarriers
  static constexpr int kSmem = kTiles + 1024 + 8 * (4 + 4 * kStages);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle layout type
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator or operand registers across a
// wgmma, which reads and writes them asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// named barriers between the two consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(kConsumerThreads) : "memory");
}

// D (64 x 128, f32) += A (64 x 16, smem) * B (16 x 128, smem); B K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, registers) * B (16 x 16, smem); B MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, smem); B MN-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem); B MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem); B MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(o, a, db, 1);
  else if constexpr (HD == 32) wgmma_rs_n32(o, a, db, 1);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db, 1);
  else wgmma_rs_n128(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One work item is a (query head, batch, 128-row query tile); items are
// numbered with the longest causal tiles first. The grid is persistent: one
// block per SM walks items blockIdx.x, + gridDim.x, ..., so that the loads
// of its next item overlap the end of the current one.
struct Item {
  int head, b, m0, kt_begin, n_tiles;
};

__device__ __forceinline__ Item item_at(int k, int n_m, int b_count, int h, int sq, int sk,
                                        int causal, int window, int q_offset) {
  Item it;
  const int per_m = h * b_count;
  it.m0 = (n_m - 1 - k / per_m) * kBM;
  it.b = (k % per_m) / h;
  it.head = k % h;
  // key tiles the item needs: up to the causal diagonal of its last real
  // row, from the window's lower edge of its first row
  const int nk = (sk + kBN - 1) / kBN;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q_offset + min(it.m0 + kBM, sq) - 1) / kBN + 1);
  it.kt_begin = 0;
  if (window > 0) {
    const int lo = q_offset + it.m0 - window + 1;
    it.kt_begin = lo > 0 ? lo / kBN : 0;
  }
  it.n_tiles = max(kt_end - it.kt_begin, 0);
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int b_count, int sq, int sk, int h, int kvh,
                 float scale, int causal, int window, int q_offset, int n_m) {
  using C = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // Q (two buffers: the next item's loads while this one runs), then the K
  // and V rings, then the mbarriers
  auto q_tile = [&](int qb) { return base + qb * C::kQBytes; };
  auto k_tile = [&](int s) { return base + 2 * C::kQBytes + s * C::kKVBytes; };
  auto v_tile = [&](int s) { return base + 2 * C::kQBytes + (kStages + s) * C::kKVBytes; };
  const uint32_t bars = base + C::kTiles;
  auto full_q = [&](int qb) { return bars + 8 * qb; };
  auto empty_q = [&](int qb) { return bars + 8 * (2 + qb); };
  auto full_k = [&](int s) { return bars + 8 * (4 + s); };
  auto empty_k = [&](int s) { return bars + 8 * (4 + kStages + s); };
  auto full_v = [&](int s) { return bars + 8 * (4 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (4 + 3 * kStages + s); };
  const int n_items = n_m * b_count * h;
  const int groups = h / kvh;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(full_q(qb), 1);
      mbar_init(empty_q(qb), kConsumerThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), kConsumerThreads);
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int g = 0;   // key tiles loaded so far by this block
      for (int k = blockIdx.x, j = 0; k < n_items; k += gridDim.x, ++j) {
        const Item it = item_at(k, n_m, b_count, h, sq, sk, causal, window, q_offset);
        const int qb = j % 2, kv_head = it.head / groups;
        mbar_wait(empty_q(qb), ((j / 2) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full_q(qb), C::kQBytes);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_4d(q_tile(qb) + c * kBM * C::kSwizzle, &tm_q, full_q(qb), c * C::kBox,
                      it.head, it.m0, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++g) {
          const int s = g % kStages, parity = ((g / kStages) & 1) ^ 1;
          const int k0 = (it.kt_begin + i) * kBN;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), C::kKVBytes);
          for (int c = 0; c < C::kBoxes; ++c)
            tma_load_4d(k_tile(s) + c * kBN * C::kSwizzle, &tm_k, full_k(s), c * C::kBox,
                        kv_head, k0, it.b);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), C::kKVBytes);
          for (int c = 0; c < C::kBoxes; ++c)
            tma_load_4d(v_tile(s) + c * kBN * C::kSwizzle, &tm_v, full_v(s), c * C::kBox,
                        kv_head, k0, it.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid - 128;
    const int cw = t / 128, warp = (t % 128) / 32, lane = t % 32;
    const int my_turn = cw == 0 ? kTurn0 : kTurn1, next_turn = cw == 0 ? kTurn1 : kTurn0;
    const int64_t q_row = static_cast<int64_t>(h) * HD;
    float acc[HD / 2], m[2], l[2], corr[2];
    float sc[64];                  // S of the current tile, then its p
    uint32_t pa[kBN / 16][4];      // p of the previous tile, the PV product's A
    int row0, qpos[2], wg_first, wg_last, kt_begin;
    uint32_t qa;

    auto issue_s = [&](int s) {    // sc = Q K_s^T
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk * 16 / C::kBox) * kBM * C::kSwizzle + (kk * 16 % C::kBox) * 2;
        wgmma_ss_n128(sc, smem_desc(qa + off, 16, 8 * C::kSwizzle, C::kLayout),
                      smem_desc(k_tile(s) + off, 16, 8 * C::kSwizzle, C::kLayout), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {   // acc += P V_s
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<HD>(acc, pa[kk],
                     smem_desc(v_tile(s) + kk * 16 * C::kSwizzle, kBN * C::kSwizzle,
                               8 * C::kSwizzle, C::kLayout));
      wgmma_commit();
    };
    // the online softmax of the item's tile i on sc, in place: sc becomes p
    auto softmax = [&](int i) {
      const int k0 = (kt_begin + i) * kBN;
      // scale, and mask only where the tile crosses Sk, the diagonal or the
      // window edge of this warpgroup's rows
      const bool masked = k0 + kBN > sk || (causal && k0 + kBN - 1 > wg_first) ||
                          (window > 0 && k0 <= wg_last - window);
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        float x = sc[j] * scale;
        if (masked) {
          const int kpos = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
          const int qp = qpos[(j % 4) / 2];
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && kpos > qp - window;
          x = ok ? x : kNegInf;
        }
        sc[j] = x;
      }
      // a row lives in the 4 lanes of a quad
      float mx[2] = {m[0], m[1]}, rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 64; ++j) mx[(j % 4) / 2] = fmaxf(mx[(j % 4) / 2], sc[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        sc[j] = exp2f((sc[j] - m[(j % 4) / 2]) * kLog2e);
        rsum[(j % 4) / 2] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
    };
    // p in bf16 pairs: S registers 8kk..8kk+7 are the A registers of k-step kk
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j % 4) / 2];
    };
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;

    // the two warpgroups take turns to issue their products (named
    // barriers), warpgroup 0 first, so that one's softmax runs under the
    // other's products; warpgroup 0 takes up the one turn left at the end
    if (cw == 1) named_arrive(kTurn0);
    int g = 0;   // key tiles consumed so far by this block
    for (int k = blockIdx.x, jt = 0; k < n_items; k += gridDim.x, ++jt) {
      const Item it = item_at(k, n_m, b_count, h, sq, sk, causal, window, q_offset);
      const int qb = jt % 2, n = it.n_tiles;
      // this thread's accumulator rows: row0 and row0 + 8
      row0 = it.m0 + cw * 64 + warp * 16 + lane / 4;
      qpos[0] = q_offset + row0;
      qpos[1] = qpos[0] + 8;
      wg_first = q_offset + it.m0 + cw * 64;
      wg_last = wg_first + 63;
      kt_begin = it.kt_begin;
      qa = q_tile(qb) + cw * 64 * C::kSwizzle;   // this warpgroup's Q rows
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      mbar_wait(full_q(qb), (jt / 2) & 1);
      if (n > 0) {
        // tile 0: its S product alone
        mbar_wait(full_k(g % kStages), (g / kStages) & 1);
        named_sync(my_turn);
        wgmma_fence();
        issue_s(g % kStages);
        named_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(g % kStages));
        softmax(0);
        pack_p();
        // tile i: S_i, and acc += P_{i-1} V_{i-1} behind it; the softmax of
        // S_i runs while the PV product is on the tensor cores
        for (int i = 1; i < n; ++i) {
          const int gi = g + i, s = gi % kStages, sp = (gi - 1) % kStages;
          mbar_wait(full_k(s), (gi / kStages) & 1);
          mbar_wait(full_v(sp), ((gi - 1) / kStages) & 1);
          rescale();
          named_sync(my_turn);
          fence_regs(acc);
          wgmma_fence();
          issue_s(s);
          issue_pv(sp);
          named_arrive(next_turn);
          wgmma_wait<1>();   // S_i is done
          fence_regs(sc);
          mbar_arrive(empty_k(s));
          softmax(i);
          wgmma_wait<0>();   // so is P_{i-1} V_{i-1}
          fence_regs(acc);
          fence_regs(pa);
          mbar_arrive(empty_v(sp));
          pack_p();
        }
        // the last tile's PV product
        const int sp = (g + n - 1) % kStages;
        mbar_wait(full_v(sp), ((g + n - 1) / kStages) & 1);
        rescale();
        named_sync(my_turn);
        fence_regs(acc);
        wgmma_fence();
        issue_pv(sp);
        named_arrive(next_turn);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty_v(sp));
      }
      mbar_arrive(empty_q(qb));   // every S product of the item is done
      g += n;

      // out = acc / max(l, 1e-30): the row sum is spread over the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if (lse != nullptr && lane % 4 == 0) {
        float* lb = lse + (static_cast<int64_t>(it.b) * h + it.head) * sq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < sq) lb[row0 + 8 * r] = row_lse(m[r], l[r]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* ob = o + (static_cast<int64_t>(it.b) * sq * h + it.head) * HD;
#pragma unroll
      for (int j = 0; j < HD / 2; j += 2) {
        const int r = (j % 4) / 2, row = row0 + 8 * r;
        const int col = 8 * (j / 4) + 2 * (lane % 4);
        if (row < sq)
          *reinterpret_cast<uint32_t*>(ob + row * q_row + col) =
              pack_bf16(acc[j] / l[r], acc[j + 1] / l[r]);
      }
    }
    if (cw == 0) named_sync(kTurn0);   // warpgroup 1's last hand-over
  }
}

// rank-4 map over (hd, heads, seq, batch) with a (box, 1, 128, 1) box
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int heads, int seq, int batch) {
  using C = Tile<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(seq) * heads * HD * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kBox), 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int b, int sq,
                int sk, int h, int kvh, float scale, int causal, int window, int q_offset,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(&tq, q, h, sq, b) || !encode<HD>(&tk, k, kvh, sk, b) ||
      !encode<HD>(&tv, v, kvh, sk, b))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_kernel<HD>;
  const int bytes = Tile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM (or per item, if fewer)
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int n_m = (sq + kBM - 1) / kBM;
  const int blocks = n_m * b * h < sms ? n_m * b * h : sms;
  kernel<<<blocks, kThreads, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                              static_cast<float*>(lse), b, sq, sk, h, kvh,
                                              scale, causal, window, q_offset, n_m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;      // query rows per block, 16 per warp
constexpr int kF32Threads = 128;  // 4 warps
constexpr int kF32Stages = 2;     // depth of the K/V ring

// A block's shared memory, in bytes of padded rows (tile_ld): Q's 64 rows,
// split once into their big halves (in place) and small ones, and a ring of
// kF32Stages K and V tiles of kKeys rows in f32, which each warp splits as it
// loads its fragments: 101,376 B at hd 128 (16-key tiles), 69,632 B at hd
// 64 (32-key tiles), two blocks an SM at every head dim.
template <int HD>
struct F32Tile {
  static constexpr int kLD = tile_ld<HD, float>();
  static constexpr int kKeys = HD == 128 ? 16 : 32;
  static constexpr int kSmem = (2 * kF32Rows + 2 * kF32Stages * kKeys) * kLD * 4;
};

// s (16 x 8 NT) = Q (16 rows, split: big halves at q, small at q_small) .
// K (8 NT rows of f32, split here)^T over HD. Each s[nt] takes its terms in
// the order scores() of flash_attention_bwd.cu gives them (a fresh chain of
// kChain k-steps, small*big, big*small, big*big, added to s), so these
// scores are dq_kernel's bit for bit, and so is the log-sum-exp the backward
// divides by. Each pair of K's n-tiles is loaded once for both.
template <int HD, int LD, int NT>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4], const float* q,
                                          const float* q_small, const float* k, int lane) {
  using P = Tf32x3;
  constexpr int kSteps = HD / P::kK, kC = kSteps < kChain ? kSteps : kChain;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += kC * P::kK) {
    P::A fa[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      fa[c] = P::load_a<LD>(q + kk + c * P::kK, q_small + kk + c * P::kK, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      float part[2][4] = {};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        P::B fb[2];
        P::load_b2_nk<LD, false>(fb, k + np * 16 * LD + kk + c * P::kK, nullptr, lane);
        P::mma(part[0], fa[c], fb[0]);
        P::mma(part[1], fa[c], fb[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * np][e] += part[0][e];
        s[2 * np + 1][e] += part[1][e];
      }
    }
  }
}

// Block i is work item i: query tile n_m - 1 - i / (h b) (the longest
// causal walks first, over every head and batch), head i % h, batch
// (i / h) % b.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int b_count, int sq, int sk, int h, int kvh,
                     float scale, int causal, int window, int q_offset) {
  using P = Tf32x3;
  constexpr int LD = F32Tile<HD>::kLD, BN = F32Tile<HD>::kKeys, NT = BN / 8;
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;                     // kF32Rows x LD: Q, then its big halves
  float* q_small = qs + kF32Rows * LD;      // kF32Rows x LD: Q's small halves
  float* ks = q_small + kF32Rows * LD;      // kF32Stages x BN x LD
  float* vs = ks + kF32Stages * BN * LD;    // kF32Stages x BN x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int per_tile = h * b_count, n_m = (sq + kF32Rows - 1) / kF32Rows;
  const int q0 = (n_m - 1 - static_cast<int>(blockIdx.x) / per_tile) * kF32Rows;
  const int head = blockIdx.x % h, b = blockIdx.x / h % b_count;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = static_cast<int64_t>(h) * HD;      // stride between positions
  const int64_t k_row = static_cast<int64_t>(kvh) * HD;
  const int64_t q_base = (static_cast<int64_t>(b) * sq * h + head) * HD;
  const int64_t k_base = (static_cast<int64_t>(b) * sk * kvh + kv_head) * HD;

  load_rows<HD, kF32Rows, kF32Threads>(qs, q + q_base, q_row, q0, sq);

  // the key tiles between the window's lower edge of the block's first row
  // and the causal diagonal of its last
  const int nk = (sk + BN - 1) / BN;
  int kt_end = nk;
  if (causal) {
    const int last = q_offset + min(q0 + kF32Rows, sq) - 1;
    kt_end = last < 0 ? 0 : min(nk, last / BN + 1);
  }
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_offset + q0 - window + 1;
    kt_begin = lo > 0 ? lo / BN : 0;
  }
  const int n = max(kt_end - kt_begin, 0);
  auto fetch = [&](int i) {
    const int st = i % kF32Stages, k0 = (kt_begin + i) * BN;
    load_rows<HD, BN, kF32Threads>(ks + st * BN * LD, k + k_base, k_row, k0, sk);
    load_rows<HD, BN, kF32Threads>(vs + st * BN * LD, v + k_base, k_row, k0, sk);
  };
  if (n > 0) fetch(0);
  cp_async_commit();   // one group: Q and key tile 0

  // this warp's rows r0 + [0, 16); this thread's r0 + g and r0 + g + 8
  const int r0 = warp * 16, q_first = q_offset + q0 + r0;
  const int qpos[2] = {q_first + g, q_first + g + 8};
  float acc[HD / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i % kF32Stages, k0 = (kt_begin + i) * BN;
    cp_async_wait<0>();   // tile i has landed (and Q, at i = 0)
    __syncthreads();      // ... for every thread, and every warp is done with tile i - 1
    if (i + 1 < n) fetch(i + 1);   // into tile i - 1's stage, under this tile's products
    cp_async_commit();
    if (i == 0) {
      split_tile<HD, P, kF32Rows, kF32Threads>(qs, q_small);
      __syncthreads();
    }
    if (!any_valid<BN>(k0, q_first, sk, causal, window)) continue;   // no pair of this warp's

    const float* kt = ks + st * BN * LD;
    float s[NT][4];
    qk_scores<HD, LD, NT>(s, qs + r0 * LD, q_small + r0 * LD, kt, lane);
    // scale, and mask only where the tile crosses Sk, the diagonal or the
    // window edge of this warp's rows
    const bool masked = k0 + BN > sk || (causal && k0 + BN - 1 > q_first) ||
                        (window > 0 && k0 <= q_first + 15 - window);
    float mx[2] = {m[0], m[1]}, corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (masked && !is_valid(k0 + nt * 8 + 2 * t + (e & 1), qpos[e / 2], sk, causal, window))
          x = kNegInf;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    // a row lives in the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f((s[nt][e] - m[e / 2]) * kLog2e);   // p
        rsum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e / 2];
    const float* vt = vs + st * BN * LD;
    accumulate<P, HD, LD, false>(acc, s, vt, vt, g, t);   // acc += p V, V split here
  }
  cp_async_wait<0>();   // no copy may land after the block has left

  // out = acc / max(l, 1e-30): the row sum is spread over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = o + q_base + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= sq) continue;
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(b) * h + head) * sq + row] = row_lse(m[r], l[r]);
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<float2*>(ob + row * q_row + nt * 8) =
          make_float2(acc[nt][2 * r] / den, acc[nt][2 * r + 1] / den);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int b, int sq,
               int sk, int h, int kvh, float scale, int causal, int window, int q_offset,
               cudaStream_t stream) {
  constexpr int bytes = F32Tile<HD>::kSmem;
  // a block may take 232,448 B; two share an SM's 233,472 B (1 KB reserved each)
  static_assert(2 * (bytes + 1024) <= 233472, "two blocks to an SM");
  auto kernel = attention_kernel_f32<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (sq + kF32Rows - 1) / kF32Rows * h * b;
  kernel<<<blocks, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), b, sq, sk,
      h, kvh, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, void*, void*, int, int, int,
                       int, int, float, int, int, int, cudaStream_t);

template <int HD>
int query_instance(bool bf16, int* out, const char** name) {
  if (bf16)
    return introspect::query(reinterpret_cast<const void*>(attention_kernel<HD>), kThreads,
                             Tile<HD>::kSmem, 1, out, name);
  return introspect::query(reinterpret_cast<const void*>(attention_kernel_f32<HD>),
                           kF32Threads, F32Tile<HD>::kSmem, 1, out, name);
}

Launch pick(int hd, Launch l16, Launch l32, Launch l64, Launch l128) {
  switch (hd) {
    case 16: return l16;
    case 32: return l32;
    case 64: return l64;
    case 128: return l128;
    default: return nullptr;
  }
}

}  // namespace

// q, o (b, sq, h, hd); k, v (b, sk, kvh, hd); all contiguous, h a multiple of
// kvh, hd in {16, 32, 64, 128}. Query row i sits at position q_offset + i,
// key j at position j. window <= 0 means no window. lse, when not null, is
// (b, h, sq) f32 and takes each row's log-sum-exp of its scaled scores over
// its valid keys (+inf on a row with none), for K3's backward; the serving
// path passes null. Each returns the CUDA error of its launch, 0 if none.

// Instance i at its launch configuration, for the kernel audit
// (introspect.cuh): 0-3 the bf16 kernel at hd 16, 32, 64, 128, 4-7 the f32
// (3xTF32) kernel at the same; arg unused.
extern "C" int flash_attention_instance(int i, int arg, int* out, const char** name) {
  (void)arg;
  if (i < 0 || i >= 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = i < 4;
  switch (i % 4) {
    case 0: return query_instance<16>(bf16, out, name);
    case 1: return query_instance<32>(bf16, out, name);
    case 2: return query_instance<64>(bf16, out, name);
    case 3: return query_instance<128>(bf16, out, name);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 inputs, 16-byte aligned: wgmma on TMA-loaded tiles
extern "C" int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                           void* o, void* lse, int b, int sq, int sk, int h,
                                           int kvh, int hd, float scale, int causal,
                                           int window, int q_offset, void* stream) {
  Launch fn = pick(hd, launch_bf16<16>, launch_bf16<32>, launch_bf16<64>, launch_bf16<128>);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, window, q_offset,
            static_cast<cudaStream_t>(stream));
}

// f32 inputs, 16-byte aligned: 3xTF32 mma.sync on a cp.async ring
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int b, int sq, int sk, int h,
                                          int kvh, int hd, float scale, int causal,
                                          int window, int q_offset, void* stream) {
  Launch fn = pick(hd, launch_f32<16>, launch_f32<32>, launch_f32<64>, launch_f32<128>);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, b, sq, sk, h, kvh, scale, causal, window, q_offset,
            static_cast<cudaStream_t>(stream));
}
