"""Serving launcher: batched prefill + greedy decode loop.

Port of ``repro/launch/serve.py`` for every registered architecture
(``configs.base.ARCH_IDS``): the transformer families (dense, MoE, VLM),
Zamba2 (hybrid), xLSTM (SSM) and Whisper (audio):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b \\
        --scale full --batch 4 --prompt 1024 --gen 32

runs on the card (``--device cpu`` runs on the host at a small ``--scale``,
which leaves an SSM configuration's ``d_ff`` as it is, as the reference's
launcher does; ``--layers`` cuts the depth to what the card holds).
xLSTM's prefill takes a prompt no longer than its chunk (256 at full size)
or a multiple of it.
Weights are drawn from seed 0 and the prompts from seed 1, as the
reference's ``PRNGKey(0)`` and ``PRNGKey(1)``. A configuration with a
vision or audio frontend gets the reference launcher's inputs unless the
caller gives its own: patch embeddings or frames of 0.02 and, with M-RoPE,
the prompt's positions on all three streams (where M-RoPE equals RoPE).
Whisper's cache holds the prompt and the generated tokens for the decoder,
and its own ``encoder_seq`` frames for cross-attention. ``serve`` is the
body, for callers that want its numbers.

On a mesh (``serve(..., mesh=...)``, or ``--model-parallel m`` under
torchrun: ``make_host_mesh(m)``, a ``(ranks / m, m)`` mesh of axes
``("data", "model")``) every family serves as the reference's
launcher serves them under ``set_rules(mesh, make_rules("decode"))``
(``src/repro/launch/serve.py:38-39``), the rules completed for the
architecture: every rank draws the same weights and prompts, keeps its part
of the parameters (``shard_params``) and its rows of the batch over
``data``, and makes its part of the KV cache, split by sequence over
``model`` (``shard_cache``); ``--expert-parallel`` splits the experts
rather than their columns. One process per rank:

    torchrun --nproc_per_node=4 -m repro_torch.launch.serve --arch qwen2_5_14b \
        --scale tiny --model-parallel 2 [--expert-parallel] --device cpu

Whisper, Zamba2 and xLSTM serve the same way: their caches' parts are
``launch.shardings.cache_specs``' (Whisper's frames' cache split by
sequence as its self-attention cache is; Zamba2's SSM and conv states by
heads and channels; xLSTM's states on their inner dims), and Whisper's
frames are split over ``data`` with the batch.

``--layout fsdp`` (``serve(layout="fsdp")``) also splits each weight's
``d_model`` over ``data`` (the dry run's FSDP rules), gathered per layer;
``--layout auto`` takes the dry run's choice by size. ``--mesh-shape
P,D,M`` lays a multi-pod ``(pod, data, model)`` mesh over the ranks, whose
batch rows go over ``("pod", "data")``. The transformer families serve
under either layout; Zamba2, xLSTM and Whisper under TP only.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.launch.shardings import shard_batch, shard_cache, shard_params
from repro_torch.models.api import build_model
from repro_torch.models.transformer import model_dtype, train_params
from repro_torch.sharding.context import get_rules, set_rules
from repro_torch.sharding.rules import LAYOUTS, complete_rules, layout_rules, make_rules

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
    """The kernels' counters: K3, K4 and K4's log-sum-exp instance."""
    return {"flash_attention": flash_attention.launches, "flash_decode": flash_decode.launches,
            "flash_decode_lse": flash_decode.lse_launches}


@dataclass
class ServeResult:
    """What one serving run did. ``logits`` holds the prefill's last-token
    logits and then each decode step's, (B, V) f32 each; ``tokens`` the
    greedy tokens fed to the decode steps, (B, gen); ``cache_pos`` the
    cache's position at the end. Launch counts are the kernels' counters over
    the prefill and over the whole decode loop.

    On a mesh the tensors are the rank's rows of the batch (the vocabulary
    whole); ``rules`` are the rules it installed, ``counters_prefill`` the
    collectives of the prefill and ``counters_steps`` each step's
    (``DeviceMesh.counters``). ``cache_bytes``: the bytes of the (rank's)
    cache. ``peak_bytes``, on a mesh on the card: the device's peak
    allocated bytes from once the rank's parameters are cut and its cache
    made (its peak stats are reset there) to the run's end, so not the
    whole model's draw; 0 otherwise. ``params_bytes``: the bytes of the
    (rank's part of the) parameters served."""

    device: torch.device
    tokens: torch.Tensor
    logits: List[torch.Tensor]
    prefill_ms: float
    decode_ms_per_token: float
    tok_per_s: float
    cache_pos: int = 0
    launches_prefill: Dict[str, int] = field(default_factory=dict)
    launches_decode: Dict[str, int] = field(default_factory=dict)
    cache_bytes: int = 0
    peak_bytes: int = 0
    rules: Optional[Dict] = None
    counters_prefill: Dict = field(default_factory=dict)
    counters_steps: List[Dict] = field(default_factory=list)
    params_bytes: int = 0


def _bytes(cache) -> int:
    """The bytes of every tensor of a cache (nested states too)."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, tuple):
        return sum(_bytes(c) for c in cache)
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_frames(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The reference launcher's audio frames: ``(B, encoder_seq, d)`` of
    0.02 in the model's dtype, on the host."""
    return torch.full((batch, cfg.encoder_seq, cfg.d_model), 0.02, dtype=model_dtype(cfg))


def prompt_tokens(cfg: ModelConfig, batch: int, prompt: int, seed: int = 0) -> torch.Tensor:
    """``serve``'s prompts: ``(batch, prompt)`` int32 tokens drawn on the
    host from seed ``seed + 1``, the same on every rank of a mesh."""
    return torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(seed + 1), dtype=torch.int32)


def prompt_inputs(cfg: ModelConfig, batch: int, prompt: int, device,
                  patch_embeds: Optional[torch.Tensor] = None,
                  mrope_pos: Optional[torch.Tensor] = None,
                  frames: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The prefill's inputs besides the tokens: ``patch_embeds`` (B, P, d)
    for a vision frontend, ``frames`` (B, encoder_seq, d) for an audio one
    and ``mrope_pos`` (3, B, S) int32 for M-RoPE, the caller's or else the
    reference launcher's (0.02 everywhere; the prompt's positions on all
    three streams)."""
    out = {}
    if cfg.frontend == "vision_patches":
        if patch_embeds is None:
            patch_embeds = torch.full((batch, cfg.num_patches, cfg.d_model), 0.02,
                                      dtype=model_dtype(cfg))
        out["patch_embeds"] = patch_embeds.to(device, model_dtype(cfg))
    if cfg.frontend == "audio_frames":
        if frames is None:
            frames = default_frames(cfg, batch)
        out["frames"] = frames.to(device, model_dtype(cfg))
    if cfg.mrope:
        if mrope_pos is None:
            mrope_pos = torch.arange(prompt, dtype=torch.int32).expand(3, batch, prompt)
        out["mrope_pos"] = mrope_pos.to(device, torch.int32)
    return out


def image_grid_positions(batch: int, seq: int, grid_h: int, grid_w: int) -> torch.Tensor:
    """Qwen2-VL's M-RoPE streams (arXiv:2409.12191 §2.1) for a prompt that
    opens with one image of ``grid_h x grid_w`` patches, row-major, and
    continues with text: patch i at (t 0, h i // grid_w, w i % grid_w), then
    text token j at ``max(grid_h, grid_w) + j`` on all three streams.
    ``(3, batch, seq)`` int32."""
    n = grid_h * grid_w
    if n > seq:
        raise ValueError(f"image_grid_positions: {n} patches in {seq} positions")
    i = torch.arange(n, dtype=torch.int32)
    text = max(grid_h, grid_w) + torch.arange(seq - n, dtype=torch.int32)
    streams = torch.stack([torch.cat([torch.zeros_like(i), text]),
                           torch.cat([i // grid_w, text]),
                           torch.cat([i % grid_w, text])])
    return streams[:, None, :].expand(3, batch, seq).contiguous()


def decode_mrope_pos(mrope_pos: torch.Tensor, gen: int) -> torch.Tensor:
    """Each decode step's ``mrope_pos``, ``(gen, 3, B, 1)``: step i of a
    sequence sits at its prompt's largest position plus 1 + i on all three
    streams (the reference launcher's ``prompt + i`` when the prompt's
    streams are its positions)."""
    nxt = mrope_pos.amax(dim=(0, 2)) + 1                                    # (B,)
    steps = nxt[None, :] + torch.arange(gen, dtype=nxt.dtype, device=nxt.device)[:, None]
    return steps[:, None, :, None].expand(gen, 3, mrope_pos.shape[1], 1).to(torch.int32)


def serve_rules(cfg: ModelConfig, mesh, expert_parallel: bool = False,
                layout: str = "tp") -> Dict:
    """``make_rules("decode")`` completed for ``cfg`` on ``mesh``'s model
    axis, as the reference's serving launcher and dry run install them:
    multi-pod on a mesh with a ``pod`` axis, laid out by ``layout``
    (``rules.layout_rules``)."""
    rules = complete_rules(cfg, make_rules("decode", multi_pod="pod" in mesh.axis_names,
                                           expert_parallel=expert_parallel),
                           int(mesh.shape["model"]))
    return layout_rules(cfg, rules, layout)


def make_mesh(model_parallel: int = 0, mesh_shape: str = "", device=None):
    """The CLIs' mesh over torchrun's ranks: ``mesh_shape`` ``"D,M"`` or
    ``"P,D,M"`` (the multi-pod axes), else ``make_host_mesh(model_parallel)``;
    None without either."""
    from repro_torch.launch.mesh import MESH_AXES, make_device_mesh, make_host_mesh

    if mesh_shape:
        shape = tuple(int(n) for n in mesh_shape.split(","))
        if len(shape) not in MESH_AXES:
            raise ValueError(f"--mesh-shape {mesh_shape!r}: give 'D,M' or 'P,D,M'")
        return make_device_mesh(shape, MESH_AXES[len(shape)], device=device)
    if model_parallel:
        return make_host_mesh(model_parallel, device=device)
    return None


def serve(cfg: ModelConfig, *, batch: int = 4, prompt: int = 32, gen: int = 32,
          device=None, seed: int = 0, params=None,
          patch_embeds: Optional[torch.Tensor] = None,
          mrope_pos: Optional[torch.Tensor] = None,
          frames: Optional[torch.Tensor] = None, mesh=None,
          expert_parallel: bool = False, layout: str = "tp",
          on_step: Optional[Callable[[int, object], None]] = None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt`` tokens, then ``gen``
    greedy decode steps. ``params`` (on ``device``) skips the random init;
    ``patch_embeds``, ``mrope_pos`` and ``frames`` replace the launcher's own
    (``prompt_inputs``); decode continues the streams (``decode_mrope_pos``).

    ``mesh`` (a ``launch.mesh.DeviceMesh``, its device the run's) serves on
    it, as the module docstring says, with ``expert_parallel`` choosing the
    MoE's split and ``layout`` the rules' (``serve_rules``); ``params`` are
    then whole (the module, or the flat dict
    with its ``axes`` as ``(flat, axes)``) and each rank keeps its part.
    ``on_step(i, cache)`` is called with the (rank's) cache after the
    prefill (``i`` 0) and after each decode step ``i``."""
    rules = None
    if mesh is not None:
        rules = serve_rules(cfg, mesh, expert_parallel, layout)
        device = mesh.device
    dev = resolve_device(device)
    api = build_model(cfg)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
    toks = prompt_tokens(cfg, batch, prompt, seed).to(dev)
    extra = prompt_inputs(cfg, batch, prompt, dev, patch_embeds, mrope_pos, frames)
    installed = get_rules()
    if mesh is None:
        cache = api.init_cache(batch, prompt + gen, dev)
    else:
        flat, axes = params if isinstance(params, tuple) else train_params(params)
        params = shard_params(flat, axes, mesh, rules)
        del flat
        inputs = shard_batch({"tokens": toks, **extra}, mesh, rules)
        toks = inputs.pop("tokens")
        extra = inputs
        cache = shard_cache(api.init_cache, batch, prompt + gen, mesh, rules, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        set_rules(mesh, rules)
    steps_pos = decode_mrope_pos(extra["mrope_pos"], gen) if cfg.mrope else None
    b = toks.shape[0]
    res = ServeResult(device=dev, tokens=toks[:, :0], logits=[], prefill_ms=0.0,
                      decode_ms_per_token=0.0, tok_per_s=0.0, rules=rules,
                      cache_bytes=_bytes(cache),
                      params_bytes=_bytes(tuple(params.values() if isinstance(params, dict)
                                                else params.parameters())))
    try:
        _sync(dev)
        if mesh is not None:
            mesh.reset_counters()
        before = _launches()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": toks, **extra}, cache)
        _sync(dev)
        res.prefill_ms = (time.perf_counter() - t0) * 1e3
        after_prefill = _launches()
        if mesh is not None:
            res.counters_prefill = mesh.counters
        if on_step is not None:
            on_step(0, cache)

        out_logits, out_toks = [logits], []
        t0 = time.perf_counter()
        for i in range(gen):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            step = {"tokens": nxt}
            if steps_pos is not None:
                step["mrope_pos"] = steps_pos[i]
            if mesh is not None:
                mesh.reset_counters()
            logits, cache = api.decode_step(params, cache, step)
            if mesh is not None:
                res.counters_steps.append(mesh.counters)
            if on_step is not None:
                on_step(i + 1, cache)
            out_logits.append(logits)
            out_toks.append(nxt)
        _sync(dev)
        dt = time.perf_counter() - t0
        after = _launches()
    finally:
        if mesh is not None:
            set_rules(*installed)
    res.tokens = torch.stack(out_toks, 1) if out_toks else toks[:, :0]
    res.logits = out_logits
    res.decode_ms_per_token = dt / max(gen, 1) * 1e3
    res.tok_per_s = b * gen / dt if gen else 0.0
    res.cache_pos = cache.pos
    if mesh is not None and dev.type == "cuda":
        res.peak_bytes = torch.cuda.max_memory_allocated(dev)
    res.launches_prefill = {k: after_prefill[k] - before[k] for k in before}
    res.launches_decode = {k: after[k] - after_prefill[k] for k in before}
    return res


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
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="split the layers and the KV cache's sequence over this many "
                         "ranks of a (data, model) mesh over torchrun's ranks")
    ap.add_argument("--mesh-shape", default="",
                    help="the mesh over torchrun's ranks instead: 'D,M' for (data, model), "
                         "'P,D,M' for the multi-pod (pod, data, model)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="on the mesh, split the MoE's experts rather than their columns")
    ap.add_argument("--layout", default="tp", choices=LAYOUTS,
                    help="on the mesh: tp, fsdp (each weight's d_model also split over "
                         "data, gathered per layer) or auto (the dry run's choice by size)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if SCALES[args.scale]:
        over = dict(SCALES[args.scale])
        if cfg.family == "ssm":
            over.pop("d_ff", None)
        cfg = cfg.replace(**over)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    mesh = make_mesh(args.model_parallel, args.mesh_shape, args.device)
    try:
        res = serve(cfg, batch=args.batch, prompt=args.prompt, gen=args.gen,
                    device=args.device, mesh=mesh, expert_parallel=args.expert_parallel,
                    layout=args.layout)
    finally:
        if mesh is not None:
            mesh.destroy()
    if mesh is not None and mesh.rank != 0:
        return res
    where = "" if mesh is None else (f" mesh={mesh.shape} layout={args.layout} (rank 0's "
                                     f"rows; its cache "
                                     f"{res.cache_bytes / 1e6:.2f} MB)")
    print(f"arch={cfg.name} device={res.device} batch={args.batch} "
          f"prompt={args.prompt} gen={args.gen} prefill {res.prefill_ms:.1f} ms, "
          f"{res.decode_ms_per_token:.1f} ms/token ({res.tok_per_s:.1f} tok/s){where}")
    print("sample:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
