#!/usr/bin/env python3
"""Time K3's backward (``flash_attention_bwd``) on one CUDA card at six
training shapes, and fingerprint its gradients.

    python3 tools/attention_bwd_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one call on
one card, in turns (other, this, this, other), as with
``tools/aggregation_times.py``. Each run prints the card's name and power
limit and one JSON line per shape: the backward's milliseconds by CUDA
events (two readings), with the forward's output and log-sum-exp computed
once beforehand by K3's plain version (so that a fingerprint depends on the
backward alone), and the SHA-256 of dQ, dK and dV on inputs drawn from a
fixed seed: two trees whose fingerprints agree give the same gradients bit
for bit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: (B, Sq, Sk, H, KV, hd, causal, dtype): the training shape of [38],
#: Qwen2-VL's of [44] and Whisper's encoder of [54] in f32 (3xTF32), then
#: a head dim of 32 in f32 and the training and Whisper shapes in bf16
SHAPES = {"training": (16, 128, 128, 40, 8, 128, True, torch.float32),
          "qwen2-vl": (4, 2048, 2048, 28, 4, 128, True, torch.float32),
          "whisper encoder": (8, 1500, 1500, 20, 20, 64, False, torch.float32),
          "hd 32": (8, 1024, 1024, 16, 4, 32, True, torch.float32),
          "training bf16": (16, 128, 128, 40, 8, 128, True, torch.bfloat16),
          "whisper encoder bf16": (8, 1500, 1500, 20, 20, 64, False, torch.bfloat16)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_torch
    from tools.aggregation_times import card_line, cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}; src: {args.src}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, s, sk, h, kvh, hd, causal, dtype) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((b, s, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)))
        o, lse = flash_attention_torch(q, k, v, causal=causal, return_lse=True)
        o = o.contiguous()
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        bwd = lambda: flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)  # noqa: E731
        grads = bwd()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()
                                        for t in grads))
        print(json.dumps({"src": args.src, "shape": name, "bwd_ms": cuda_ms(bwd, 20),
                          "bwd_ms_again": cuda_ms(bwd, 20),
                          "grads_sha256": digest.hexdigest()[:16]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
