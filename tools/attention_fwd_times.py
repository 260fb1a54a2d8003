#!/usr/bin/env python3
"""Time K3's f32 forward (``flash_attention``) on one CUDA card at the
shapes the training and f32 serving paths give it, beside SDPA and its two
bounds, and fingerprint its output.

    python3 tools/attention_fwd_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one call on
one card, in turns (other, this, this, other), as with
``tools/attention_bwd_times.py``. Each run prints the card's name and power
limit, ptxas's lines for the f32 kernel, and one JSON line per shape: the
kernel's milliseconds by CUDA events (two readings, the wrapper in the
loop) and its device time per launch by ``torch.profiler`` (without the
host's work, which sets the launch-sized shapes' times), SDPA's (``scaled_dot_product_attention`` on the same inputs, the KV
heads repeated outside the call, a window as an explicit mask), the
kernel's TFLOP/s on its two products, its bound on the f32 CUDA cores and
on its 3xTF32 route (``kernel_audit.cost_model``), its largest distance
from the plain version in o and in the log-sum-exp, whether two calls gave
the same bits, and the SHA-256 of o and the log-sum-exp on inputs drawn
from a fixed seed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: (B, Sq, Sk, H, KV, hd, causal, window), f32, with the chip_smoke.py phase
#: that runs each: a rank's prefill in sharded f32 serving, the training
#: shapes of Qwen2-VL, Whisper (encoder, cross and decoder, and a (1, 2)
#: rank's encoder and cross), Zamba2 (and a (2, 2) rank), the training round
#: and its (1, 2) and (1, 4) ranks, and Mixtral's (1, 2) prefill rank past
#: its window
SHAPES = {"serving (1, 4) rank [68]": (4, 1024, 1024, 10, 2, 128, True, 0),
          "serving (1, 2) rank [68]": (2, 1024, 1024, 20, 4, 128, True, 0),
          "qwen2-vl training [44]": (4, 2048, 2048, 28, 4, 128, True, 0),
          "whisper encoder (1, 2) rank [73]": (4, 1500, 1500, 10, 10, 64, False, 0),
          "whisper cross [54]": (8, 448, 1500, 20, 20, 64, False, 0),
          "training [38]": (16, 128, 128, 40, 8, 128, True, 0),
          "whisper encoder [54]": (8, 1500, 1500, 20, 20, 64, False, 0),
          "whisper decoder [54]": (8, 448, 448, 20, 20, 64, True, 0),
          "zamba2 training [49]": (8, 512, 512, 32, 32, 64, True, 0),
          "mixtral (1, 2) rank [68]": (2, 4160, 4160, 24, 4, 128, True, 4096),
          "training (1, 2) rank [64]": (8, 128, 128, 20, 4, 128, True, 0),
          "training (1, 4) rank [64]": (8, 128, 128, 10, 2, 128, True, 0),
          "whisper cross (1, 2) rank [73]": (4, 128, 1500, 10, 10, 64, False, 0),
          "zamba2 (2, 2) rank [73]": (2, 128, 128, 16, 16, 64, True, 0)}


def valid_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Valid (query, key) pairs of one (batch, head), query i at position i."""
    rows = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(rows, max=sk - 1) if causal else torch.full_like(rows, sk - 1)
    lo = torch.clamp(rows - window + 1, min=0) if window > 0 else torch.zeros_like(rows)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def device_ms(fn, calls: int = 10) -> float | None:
    """Mean device milliseconds of the f32 kernel's launches over ``calls``
    calls of ``fn``, by torch.profiler (None if it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "attention_kernel_f32" in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_fwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch.nn.functional as F

    from repro_torch.analysis.kernel_audit import cost_model, parse_ptxas, roofline
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch
    from tools.aggregation_times import card_line, cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}; src: {args.src}")
    for fn, info in parse_ptxas(_build.build().logs["flash_attention"]).items():
        if "attention_kernel_f32" in fn:
            print(f"  ptxas {fn}: {info.regs} registers, {info.spill_stores} B of spill "
                  f"stores, {info.spill_loads} B of spill loads, {info.stack} B of stack")
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, sq, sk, h, kvh, hd, causal, window) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)))
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention(q, k, v, **kw, return_lse=True)
        o2, lse2 = flash_attention(q, k, v, **kw, return_lse=True)
        o_plain, lse_plain = flash_attention_torch(q, k, v, **kw, return_lse=True)
        torch.cuda.synchronize()
        fin = torch.isfinite(lse_plain)
        err_o = float((o - o_plain).abs().max())
        err_lse = float((lse[fin] - lse_plain[fin]).abs().max())
        same_inf = bool((torch.isinf(lse) == ~fin).all())
        del o_plain, lse_plain
        digest = hashlib.sha256(b"".join(
            t.cpu().contiguous().view(torch.uint8).numpy().tobytes() for t in (o, lse)))
        same = bool(o.equal(o2) and lse.equal(lse2))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
                  for x in (k, v))
        mask = None
        if window > 0:
            qpos = torch.arange(sq, device="cuda")[:, None]
            kpos = torch.arange(sk, device="cuda")
            mask = (kpos <= qpos) & (kpos > qpos - window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
        fwd = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
        with torch.no_grad():
            t1, t_lib, t2 = cuda_ms(fwd, 20), cuda_ms(sdpa, 20), cuda_ms(fwd, 20)
            t_dev = device_ms(fwd)
        c = cost_model("flash_attention", b=b, sq=sq, h=h, kv=kvh, hd=hd, keys=sk,
                       pairs=valid_pairs(sq, sk, causal, window), dtype="f32")
        # the 3xTF32 route: each product 3 TF32 products (cost_model's
        # extra["route_ms"]; priced here too, for a tree whose model lacks it)
        route, route_by = roofline(c.bytes, 3 * c.flops, "tf32")
        print(json.dumps({
            "src": args.src, "shape": name, "ms": t1, "ms_again": t2, "device_ms": t_dev,
            "sdpa_ms": t_lib,
            "tflops": c.flops / min(t1, t2) / 1e9, "bound_ms": c.bound_ms,
            "bound_by": c.bound_by, "bound_ms_route": route, "bound_by_route": route_by,
            "max_abs_err": err_o,
            "lse_max_abs_err": err_lse, "inf_rows_agree": same_inf, "two_calls_same": same,
            "out_sha256": digest.hexdigest()[:16]}), flush=True)
        del q, k, v, o, lse, o2, lse2, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
