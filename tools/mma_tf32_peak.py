#!/usr/bin/env python3
"""Measure what ``mma.sync.m16n8k8`` TF32 reaches on one CUDA card: the
ceiling of K3's 3xTF32 products (``csrc/warp_mma.cuh``), which the data
sheet's 495 TFLOP/s TF32 (``wgmma``) does not give.

    python3 tools/mma_tf32_peak.py

Each warp of 4-warp blocks runs CHAINS independent accumulators through a
loop of ``mma_tf32`` with its operands in registers (no loads, no
dependence between chains), at 4, 8 and 16 blocks an SM. The kernel is
built with ``nvcc`` (sm_90a) into ``build/tools/``; each line gives the
card's name and power limit and the TFLOP/s by CUDA events.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include <cuda_runtime.h>
#include "warp_mma.cuh"
template <int CHAINS>
__global__ void __launch_bounds__(128) peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i);
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) warp_mma::mma_tf32(d[c], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the products live
}
extern "C" int mma_peak(float* out, int blocks, int iters, int chains, void* stream) {
  if (chains == 8) peak<8><<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  else peak<16><<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tools.aggregation_times import card_line, cuda_ms

    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_peak.cu").write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I",
                    str(ROOT / "src" / "repro_torch" / "kernels" / "csrc"), "-o",
                    str(out_dir / "mma_peak.so"), str(out_dir / "mma_peak.cu")], check=True)
    lib = ctypes.CDLL(str(out_dir / "mma_peak.so"))
    lib.mma_peak.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for chains in (8, 16):
        for per_sm in (4, 8, 16):
            blocks = sms * per_sm
            ms = cuda_ms(lambda: lib.mma_peak(out.data_ptr(), blocks, iters, chains, stream), 5, 2)
            flops = blocks * 4 * iters * chains * 2 * 16 * 8 * 8
            print(f"card: {card_line()}; mma.sync m16n8k8 TF32, {chains} chains a warp, "
                  f"{per_sm} blocks of 4 warps an SM: {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
