"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

    union_segsum        K1, the trainer's server aggregation
    heat_scatter        K2 (``rowsparse_scatter``), the dense-output twin
    flash_attention     K3, causal GQA attention of the transformer's prefill
    flash_decode        K4, one token against the KV cache in every decode step
    introspect          the audit registry of them all (analysis/kernel_audit.py)

Each module keeps a plain PyTorch version beside its kernel and a launch
counter on its wrapper. The CUDA sources build on first use (``_build``).
"""
