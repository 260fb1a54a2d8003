"""Serving launcher: batched prefill + greedy decode loop.

Port of ``repro/launch/serve.py`` for every registered architecture of the
transformer families (dense and MoE; ``configs.base.ARCH_IDS``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \\
        --scale full --batch 4 --prompt 1024 --gen 32

runs on the card (``--device cpu`` runs on the host at a small ``--scale``;
``--layers`` cuts the depth to what the card holds).
Weights are drawn from seed 0 and the prompts from seed 1, as the
reference's ``PRNGKey(0)`` and ``PRNGKey(1)``. ``serve`` is the body, for
callers that want its numbers.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.api import build_model

SCALES = {
    # overrides applied to the arch config for CPU-runnable scales
    # (repro/launch/train.py's table)
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=256, vocab_size=2048, dtype="float32",
                 query_chunk=64, kv_chunk=64, num_patches=8, encoder_seq=64,
                 encoder_layers=2, mrope_sections=(4, 6, 6)),
    "100m": dict(num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
                 head_dim=64, d_ff=1408, vocab_size=8192, dtype="float32",
                 query_chunk=128, kv_chunk=128, num_patches=16, encoder_seq=128,
                 encoder_layers=8, mrope_sections=(8, 12, 12)),
    "full": {},
}


def _launches() -> Dict[str, int]:
    return {"flash_attention": flash_attention.launches,
            "flash_decode": flash_decode.launches}


@dataclass
class ServeResult:
    """What one serving run did. ``logits`` holds the prefill's last-token
    logits and then each decode step's, (B, V) f32 each; ``tokens`` the
    greedy tokens fed to the decode steps, (B, gen); ``cache_pos`` the
    cache's position at the end. Launch counts are the kernels' counters over
    the prefill and over the whole decode loop."""

    device: torch.device
    tokens: torch.Tensor
    logits: List[torch.Tensor]
    prefill_ms: float
    decode_ms_per_token: float
    tok_per_s: float
    cache_pos: int = 0
    launches_prefill: Dict[str, int] = field(default_factory=dict)
    launches_decode: Dict[str, int] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt: int = 32, gen: int = 32,
          device=None, seed: int = 0, params=None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt`` tokens, then ``gen``
    greedy decode steps. ``params`` (on ``device``) skips the random init."""
    dev = resolve_device(device)
    api = build_model(cfg)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
    prompt_gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=prompt_gen,
                         dtype=torch.int32).to(dev)
    cache = api.init_cache(batch, prompt + gen, dev)

    _sync(dev)
    before = _launches()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, {"tokens": toks}, cache)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = _launches()

    out_logits, out_toks = [logits], []
    t0 = time.perf_counter()
    for _ in range(gen):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = api.decode_step(params, cache, {"tokens": nxt})
        out_logits.append(logits)
        out_toks.append(nxt)
    _sync(dev)
    dt = time.perf_counter() - t0
    after = _launches()
    return ServeResult(
        device=dev,
        tokens=torch.stack(out_toks, 1) if out_toks else toks[:, :0],
        logits=out_logits, prefill_ms=prefill_ms,
        decode_ms_per_token=dt / max(gen, 1) * 1e3,
        tok_per_s=batch * gen / dt if gen else 0.0, cache_pos=cache.pos,
        launches_prefill={k: after_prefill[k] - before[k] for k in before},
        launches_decode={k: after[k] - after_prefill[k] for k in before})


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_14b")
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted (raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if SCALES[args.scale]:
        cfg = cfg.replace(**SCALES[args.scale])
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    res = serve(cfg, batch=args.batch, prompt=args.prompt, gen=args.gen,
                device=args.device)
    print(f"arch={cfg.name} device={res.device} batch={args.batch} "
          f"prompt={args.prompt} gen={args.gen} prefill {res.prefill_ms:.1f} ms, "
          f"{res.decode_ms_per_token:.1f} ms/token ({res.tok_per_s:.1f} tok/s)")
    print("sample:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
