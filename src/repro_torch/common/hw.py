"""Single source of the target hardware's constants: one NVIDIA H100 SXM.

The port's counterpart of ``repro/common/hw.py`` (TPU v5e there). Every
analytic model of the port reads THIS dict: the kernel cost model and the
resource limits of ``repro_torch.analysis.kernel_audit``, and the bounds
``chip_smoke.py`` and ``tools/`` print. Two models quoting different peaks
would make their shares of the bound incomparable, so the constants live in
one place, and a test pins every consumer to the same object.

Rates are NVIDIA's data sheet for the SXM part at its 700 W limit, dense
(no structured sparsity); the limits are sm_90's (CUDA C++ Programming
Guide, compute capability 9.0). A card set below 700 W runs slower under
load; ``nvidia-smi`` reports its limit, which every measurement states.
``chip_smoke.py`` [60] holds the entries that
``torch.cuda.get_device_properties`` exposes against the card.
"""
from __future__ import annotations

HW = {
    # rates
    "hbm_bandwidth": 3.35e12,          # B/s, HBM3
    "peak_flops_f32": 67e12,           # FLOP/s, f32 on the CUDA cores
    "peak_flops_tf32": 495e12,         # FLOP/s, TF32 tensor cores
    "peak_flops_bf16": 989e12,         # FLOP/s, bf16 tensor cores
    # sizes
    "hbm_bytes": 80 * 10**9,           # device memory
    "l2_bytes": 50 * 2**20,            # L2 cache
    # sm_90's limits
    "sms": 132,
    "regs_per_sm": 65536,              # 32-bit registers
    "regs_per_thread": 255,
    "smem_per_sm": 228 * 1024,         # shared memory an SM has for blocks
    "smem_per_block": 227 * 1024,      # a block's most, dynamic above 48 KB (opt-in)
    "threads_per_block": 1024,
    "max_cluster": 8,                  # portable thread-block cluster
}
