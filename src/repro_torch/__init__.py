"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

Mirrors ``repro``'s subpackage layout, one port file per reference file. The
package imports ``torch`` and numpy only; the server aggregation runs through
hand-written CUDA kernels (``repro_torch.kernels``) built with ``nvcc`` on
first use.

Device rule: every entry point runs on ``"cuda"`` unless the caller passes
``device="cpu"``; with no card, the default raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; it raises when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available: pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
