#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which asserts; any failure exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN (both stated here: every comparison below is in
   full float32), build the CUDA kernels from ``src/repro_torch/kernels/csrc``
2. K1 ``union_segsum`` against its plain PyTorch version on the card, at
   the trainer's shapes, a wide shape, D = 18 and 25 (DIN's and the LSTM's
   widths), a hot cohort (one id in each of 1,000 clients) and the heavy
   shape (V = 2^22, 1,000 clients x 512 rows, D = 18), f32 and bf16, with
   and without heat, ids >= V, all-pad clients, an overflowing union, and
   two calls back to back on one V
3. K2 ``rowsparse_scatter`` against its plain version on the card, on the
   same kinds of cases
4. the main path at full width: LR FedSubAvg on MovieLens-1M-sized data
   (6,040 clients, 3,706 movies, ~1.0M ratings, V = 37,069 features),
   K = 100 clients per round, fedsubavg, fedavg and fedsubavg with top-16
   transport, 20 rounds each through ``run_round`` and ``run``; K1 must
   serve every round. K2's own path (``aggregate_rowsparse_dense``) follows
5. card against host: the same trainer for 5 rounds on ``device="cpu"``
   (the plain versions); losses and final parameters within 1e-5
6. K1 and K2 times (CUDA events) at the trainer's round and at the heavy
   shape (f32 and bf16) beside their plain versions, one PyTorch stand-in
   each and the HBM bound, with device ops and device time per call
   (torch.profiler: one op each), K1's scratch bytes, and the redesign's
   targets marked met or missed
7. where a round's time goes: host sampling, device kernel time and
   launches per round (torch.profiler), K1 in the round, the device's busy
   share
8. K3 ``flash_attention`` against its plain version on the card: the
   serving prefill's shape (B 4, S 1024, H 40, KV 8, hd 128) in bf16 (the
   tensor-core kernel) and f32 (the CUDA-core kernel), a sliding window,
   bf16 at every other head dim (16, 32, 64), MHA at hd 64, non-causal,
   ragged lengths, a continuation (Sq not a multiple of 128, Sk > Sq,
   q_offset > 0) and a window whose edge falls inside a 128-row tile.
   Kernel against plain version throughout: 2e-5 in f32; 2e-2 in bf16, and
   also 1e-2 in relative norm
9. K4 ``flash_decode`` against its plain version: the decode step's shape
   (B 4, H 40, KV 8, 1,056 slots, hd 128) in bf16 and f32, a part-filled
   cache with -1 slots, a wrapped ring buffer with a window, and an empty
   row (every position above ``q_position``: the mean of V)
10. the serving path at full size: Qwen2.5-14B from its published config
    (48 layers, bf16, random weights from seed 0) through
    ``repro_torch.launch.serve``: prefill of 4 x 1,024 tokens, then 32
    greedy decode steps; K3 must serve 48 launches in prefill and K4 48 per
    decode step; logits finite
11. card against host: the same model at full width with 2 layers in f32,
    1 x 256 prompt tokens and 8 decode steps, on the card and on
    ``device="cpu"``; logits within 1e-4, greedy tokens identical
12. K3 and K4 times at the serving path's own inputs (recorded in an
    untimed rerun of [10]'s request) beside their plain versions,
    ``scaled_dot_product_attention`` and the bound, with the achieved
    TFLOP/s (K3) and TB/s (K4)
13. where a decode step's time goes (torch.profiler), K4's split pass per
    launch, the device's busy share
14. where a prefill's time goes (torch.profiler over one prefill of
    4 x 1,024 tokens): device time by op, K3's total over its 48 launches,
    the matmuls' total, the device's busy share

It ends with the kernels as one JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.

"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.synthetic import make_movielens_like  # noqa: E402
from repro_torch.federated.plan import (RoundPlan, RowSparseTransport,  # noqa: E402
                                        ServerUpdate, SubmodelReplicatedLocal)
from repro_torch.federated.server import FederatedTrainer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build, _rows  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_torch)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_torch  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import cache_slot_positions  # noqa: E402
from repro_torch.kernels.heat_scatter import (rowsparse_scatter,  # noqa: E402
                                              rowsparse_scatter_torch)
from repro_torch.kernels.union_segsum import (union_segsum,  # noqa: E402
                                              union_segsum_torch)
from repro_torch.models.recsys import lr_logits, lr_loss, make_lr_params  # noqa: E402
from repro_torch.sparse import aggregate as aggregate_mod  # noqa: E402
from repro_torch.sparse.aggregate import aggregate_rowsparse_dense  # noqa: E402
from repro_torch.sparse.rowsparse import RowSparse  # noqa: E402
from tools.aggregation_times import N_CLIENTS, SHAPES, cohort, cuda_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
OPS_PER_S = {torch.float32: F32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:14-15
BF16_REL_TOL = 1e-2            # ||got - want|| / ||want|| for bf16 comparisons
SEED = 0
DEV = torch.device("cuda")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def compare(name, got, want, dtype) -> float:
    """Max abs error of ``got`` against ``want``, held to ``TOL``; bf16 is
    also held to ``BF16_REL_TOL`` in relative norm, since its element bound
    is loose against small outputs."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = TOL[dtype]
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"{name}: kernel disagrees with its plain version (max abs err {err})")
    if dtype == torch.bfloat16 and got.numel():
        rel = float(torch.linalg.vector_norm((got - want).float())
                    / torch.linalg.vector_norm(want.float()).clamp(min=1e-30))
        check(rel <= BF16_REL_TOL, f"{name}: relative error {rel} > {BF16_REL_TOL}")
        print(f"    {name}: bf16 relative error {rel:.3g}")
    return err


def phase_k1(rng) -> float:
    v, k, r, _ = SHAPES["trainer"]
    hv, hk, hr, hd = SHAPES["heavy"]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("main", v, k, r, 1, dtype, {}, True, None),
                  ("wide", 262_144, 16, 2_048, 16, dtype, {}, True, None),
                  ("D=18", v, k, r, 18, dtype, {}, True, None),
                  ("D=25", v, k, r, 25, dtype, {}, True, None),
                  ("hot", v, 1000, r, 18, dtype, {"hot": 7}, True, None),
                  ("heavy", hv, hk, hr, hd, dtype, {}, True, None)]
    cases += [
        ("no-heat", v, k, r, 1, torch.float32, {}, False, None),
        ("ids>=V", v, k, r, 1, torch.float32, {"out_of_range": 0.05}, True, None),
        ("ids>=V", v, k, r, 25, torch.float32, {"out_of_range": 0.05}, True, None),
        ("all-pad", v, k, r, 1, torch.float32, {"all_pad": 10}, True, None),
        ("overflow", v, k, r, 1, torch.float32, {}, True, "half"),
        ("overflow", v, k, r, 18, torch.bfloat16, {}, True, "half"),
    ]
    worst = 0.0
    for name, vv, kk, rr, d, dtype, kw, with_heat, cap in cases:
        ids, rows, heat = cohort(rng, kk, rr, vv, d, dtype, DEV, **kw)
        heat = heat if with_heat else None
        union = int(torch.unique(ids[(ids >= 0) & (ids < vv)]).numel())
        c = union // 2 if cap == "half" else min(vv, kk * rr)
        err = check_k1(f"union_segsum[{name}]", (ids, rows, heat, float(N_CLIENTS), c, vv),
                       1.0 / kk, union)
        worst = max(worst, err)
        print(f"  K1 {name:8s} {str(dtype):14s} V={vv} T={kk * rr} D={d} cap={c} "
              f"union={union} max_abs_err={err:.3g}")
    # back to back on one V: a large union, then a small one into the same
    # capacity; each is held to its plain version after both have run
    first = cohort(rng, k, r, v, 18, torch.float32, DEV)
    second = cohort(rng, 8, 16, v, 18, torch.float32, DEV)
    cap = k * r
    outs = [union_segsum(*c, float(N_CLIENTS), cap, v, scale=0.5) for c in (first, second)]
    for i, (c, (got_ids, got_rows)) in enumerate(zip((first, second), outs)):
        want_ids, want_rows = union_segsum_torch(*c, float(N_CLIENTS), cap, v, scale=0.5)
        torch.cuda.synchronize()
        check(torch.equal(got_ids, want_ids), f"union_segsum[back-to-back {i}]: ids differ")
        err = compare(f"union_segsum[back-to-back {i}]", got_rows, want_rows, torch.float32)
        worst = max(worst, err)
        print(f"  K1 back-to-back call {i}: V={v} T={c[0].numel()} D=18 cap={cap} "
              f"union={int((want_ids >= 0).sum())} max_abs_err={err:.3g}")
    return worst


def check_k1(name, args, scale, union) -> float:
    """One K1 call against its plain version: ids exact, the union's size,
    rows within tolerance."""
    got_ids, got_rows = union_segsum(*args, scale=scale)
    want_ids, want_rows = union_segsum_torch(*args, scale=scale)
    torch.cuda.synchronize()
    check(torch.equal(got_ids, want_ids), f"{name}: ids differ")
    check(int((got_ids >= 0).sum()) == min(union, args[4]), f"{name}: union size")
    return compare(name, got_rows, want_rows, args[1].dtype)


def phase_k2(rng) -> float:
    v, k, r, _ = SHAPES["trainer"]
    hv, hk, hr, hd = SHAPES["heavy"]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("main", v, k, r, 1, dtype, {}),
                  ("wide", 65_536, 16, 2_048, 16, dtype, {}),
                  ("D=18", v, k, r, 18, dtype, {}),
                  ("D=25", v, k, r, 25, dtype, {}),
                  ("hot", v, 1000, r, 18, dtype, {"hot": 7}),
                  ("heavy", hv, hk, hr, hd, dtype, {})]
    cases += [("ids>=V", v, k, r, 25, torch.float32, {"out_of_range": 0.05}),
              ("all-pad", v, k, r, 18, torch.float32, {"all_pad": 10})]
    worst = 0.0
    for name, vv, kk, rr, d, dtype, kw in cases:
        ids, rows, heat = cohort(rng, kk, rr, vv, d, dtype, DEV, **kw)
        args = (ids.reshape(-1), rows.reshape(kk * rr, d), heat, float(N_CLIENTS), vv)
        got = rowsparse_scatter(*args, scale=1.0 / kk)
        want = rowsparse_scatter_torch(*args, scale=1.0 / kk)
        err = compare(f"rowsparse_scatter[{name}]", got, want, dtype)
        worst = max(worst, err)
        del got, want
        print(f"  K2 {name:8s} {str(dtype):14s} V={vv} T={kk * rr} D={d} max_abs_err={err:.3g}")
    # back to back on one V, each held to its plain version after both ran
    calls = [cohort(rng, kk, rr, v, 18, torch.float32, DEV) for kk, rr in ((k, r), (8, 16))]
    args = [(i.reshape(-1), w.reshape(i.numel(), 18), h, float(N_CLIENTS), v)
            for i, w, h in calls]
    outs = [rowsparse_scatter(*a, scale=0.5) for a in args]
    for i, (a, got) in enumerate(zip(args, outs)):
        err = compare(f"rowsparse_scatter[back-to-back {i}]", got,
                      rowsparse_scatter_torch(*a, scale=0.5), torch.float32)
        worst = max(worst, err)
        print(f"  K2 back-to-back call {i}: V={v} T={a[0].numel()} D=18 max_abs_err={err:.3g}")
    return worst


def make_trainer(ds, alg: str, device, plan=None) -> FederatedTrainer:
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100,
                    local_iters=5, local_batch=5, lr=0.5, algorithm=alg,
                    sparse=True, seed=SEED)
    return FederatedTrainer(ds, lambda device: make_lr_params(ds.num_features, device),
                            lr_loss, cfg, predict_fn=lambda p, t: lr_logits(p, t["features"]),
                            plan=plan, device=device)


def drive(tr: FederatedTrainer, label: str) -> dict:
    """20 rounds: 10 through ``run_round`` (timed one by one), 10 through
    ``run`` with the multi-round engine, then the evaluation record."""
    losses, ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(tr.run_round())          # reads the loss back: a sync
        ms.append((time.perf_counter() - t0) * 1e3)
    before = len(tr.history)
    tr.run(10, eval_every=10, engine=True)
    rec = tr.history[before]
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    check(math.isfinite(rec.train_loss) and rec.train_loss < losses[0],
          f"{label}: train loss did not fall ({losses[0]} -> {rec.train_loss})")
    check(0.5 < rec.test_metric <= 1.0, f"{label}: AUC {rec.test_metric}")
    out = {"round_loss": losses, "round_ms": ms,
           "steady_ms_per_round": statistics.median(ms[2:]),
           "run_ms_per_round": rec.wall_time * 1e3,
           "train_loss": rec.train_loss, "auc": rec.test_metric,
           "capacity": tr._last_capacity}
    print(f"  {label}: per-round loss {[round(x, 5) for x in losses]}")
    print(f"  {label}: after 20 rounds train_loss={rec.train_loss:.5f} "
          f"auc={rec.test_metric:.5f}; ms/round run_round median "
          f"{out['steady_ms_per_round']:.2f}, run(engine) {out['run_ms_per_round']:.2f}")
    return out


def phase_main_path(ds) -> tuple:
    """The trainer at full width. Returns the per-run summaries, the K1
    launch count of the run and the K1 inputs of one fedsubavg round."""
    captured = {}

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return union_segsum(*args, **kw)

    union_segsum.launches = 0
    rowsparse_scatter.launches = 0
    runs = {}
    aggregate_mod.union_segsum = capture       # records the main path's inputs
    try:
        runs["fedsubavg"] = drive(make_trainer(ds, "fedsubavg", DEV), "fedsubavg")
    finally:
        aggregate_mod.union_segsum = union_segsum
    check(union_segsum.launches == 20, f"K1 served {union_segsum.launches}/20 rounds")
    runs["fedavg"] = drive(make_trainer(ds, "fedavg", DEV), "fedavg")
    check(union_segsum.launches == 40, f"K1 served {union_segsum.launches}/40 rounds")
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(topk=16),
                     ServerUpdate("fedsubavg"))
    runs["fedsubavg_top16"] = drive(make_trainer(ds, "fedsubavg", DEV, plan),
                                    "fedsubavg top-16")
    launches = union_segsum.launches
    check(launches == 60, f"K1 served {launches}/60 rounds")
    return runs, launches, captured


def phase_k2_path(k1_args) -> tuple:
    """K2's own path: the dense-output cohort aggregation of the main path's
    round, against the union-then-scatter path on the host."""
    ids, rows, heat, total, cap, v = k1_args
    k = 100
    stacked = RowSparse(ids.reshape(k, -1), rows.reshape(k, ids.numel() // k, -1), v)
    rowsparse_scatter.launches = 0
    dense = aggregate_rowsparse_dense(stacked, heat, total, scale=1.0 / k)
    launches = rowsparse_scatter.launches
    check(launches == 1, f"K2 launched {launches} times on its path")
    host = aggregate_rowsparse_dense(
        RowSparse(stacked.ids.cpu(), stacked.rows.cpu(), v), heat.cpu(), total,
        scale=1.0 / k)
    err = float((dense.cpu() - host).abs().max())
    check(torch.allclose(dense.cpu(), host, rtol=2e-5, atol=2e-5),
          f"K2 path disagrees with the host path (max abs err {err})")
    print(f"  K2 path: aggregate_rowsparse_dense V={v} T={ids.numel()} "
          f"launches={launches} max_abs_err vs host={err:.3g}")
    return launches, err


def phase_card_vs_host(ds) -> dict:
    out = {}
    for alg in ("fedsubavg", "fedavg"):
        card, host = make_trainer(ds, alg, DEV), make_trainer(ds, alg, "cpu")
        lc = [card.run_round() for _ in range(5)]
        lh = [host.run_round() for _ in range(5)]
        dl = max(abs(a - b) for a, b in zip(lc, lh))
        check(np.allclose(lc, lh, rtol=1e-5, atol=1e-5),
              f"{alg}: card and host losses differ by {dl}")
        dp = 0.0
        for name, p in card.state.params.items():
            q = host.state.params[name]
            dp = max(dp, float((p.cpu() - q).abs().max()))
            check(torch.allclose(p.cpu(), q, rtol=1e-5, atol=1e-5),
                  f"{alg}: card and host '{name}' differ by {dp}")
        out[alg] = {"max_loss_diff": dl, "max_param_diff": dp}
        print(f"  {alg}: 5 rounds card vs host: max |loss diff| {dl:.3g}, "
              f"max |param diff| {dp:.3g}")
    return out


def phase_profile(ds, steady_ms: float) -> dict:
    """Where one fedsubavg round's time goes: host sampling, device kernel
    time and launches per round (torch.profiler over 5 warm rounds), and the
    device's busy share of the unprofiled steady round time."""
    from torch.profiler import ProfilerActivity, profile

    tr = make_trainer(ds, "fedsubavg", DEV)
    for _ in range(3):
        tr.run_round()
    t0 = time.perf_counter()
    for _ in range(5):
        tr._sample_sparse_cohort()
    sample_ms = (time.perf_counter() - t0) / 5 * 1e3
    n = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            tr.run_round()
        torch.cuda.synchronize()
    by_name, launches = device_times(prof)
    device_ms = sum(by_name.values()) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"host_sampling_ms_per_round": sample_ms,
           "device_kernel_ms_per_round": device_ms,
           "device_ops_per_round": launches / n,
           "steady_ms_per_round": steady_ms,
           "device_busy_share": device_ms / steady_ms if device_ms else None,
           "top_device_ops_ms_per_round": [(k[:90], v / n / 1e3) for k, v in top]}
    print(f"  fedsubavg round: {steady_ms:.2f} ms steady; host sampling "
          f"{sample_ms:.2f} ms; device ops {launches / n:.0f}/round, "
          f"{device_ms:.3f} ms busy ({(out['device_busy_share'] or 0) * 100:.1f}%)")
    for name, ms in out["top_device_ops_ms_per_round"]:
        print(f"    {ms:.4f} ms/round  {name}")
    k1 = {name: us for name, us in by_name.items() if "union_segsum_kernel" in name}
    check(len(k1) == 1, f"K1 in the round: {sorted(k1)}")
    print(f"    K1 in the round: {sum(k1.values()) / n / 1e3:.4f} ms/round  {next(iter(k1))[:90]}")
    return out


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: targets of the kernels' redesign: ms per call at the trainer's round, and
#: the least share of the bound at the heavy shape
K1_TARGET_MS, K1_TARGET_SHARE = 0.03, 0.25
K2_TARGET_MS, K2_TARGET_SHARE = 0.02, 0.50


def k1_library(flat_ids, flat_rows, heat, total, scale):
    """One PyTorch route to K1's function: ``torch.unique`` + ``index_add_``
    + the factor (the -1 pad is a union entry here; it is a yardstick only)."""
    u, inv = torch.unique(flat_ids, sorted=True, return_inverse=True)
    out = torch.zeros((u.numel(), flat_rows.shape[1]), device=DEV).index_add_(
        0, inv, flat_rows.float())
    h = heat[u.clamp(min=0)]
    f = torch.where(h > 0, total / h.clamp(min=1.0), 0.0) * scale
    return u, out * torch.where(u >= 0, f, 0.0)[:, None]


def k2_library(flat_ids, flat_rows, heat, total, v, scale):
    """One PyTorch route to K2's function: ``index_add_`` + the factor."""
    keep = flat_ids >= 0
    out = torch.zeros((v, flat_rows.shape[1]), device=DEV).index_add_(
        0, flat_ids.clamp(min=0).long(), flat_rows.float() * keep[:, None])
    f = torch.where(heat > 0, total / heat.clamp(min=1.0), 0.0)
    return out * f[:, None] * scale


def profile_calls(fn, n: int = 5) -> tuple:
    """Device ops and device milliseconds per call of ``fn``, and the device
    ops' names (torch.profiler over ``n`` warm calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name, ops = device_times(prof)
    return ops / n, sum(by_name.values()) / n / 1e3, sorted(by_name)


def time_k1_k2(k1_args, scale: float, label: str) -> dict:
    """K1 and K2 on one cohort: kernel, plain version and library call by
    CUDA events in turns (plain / kernel / kernel / plain), the bound, and
    device ops and device time per call from the profiler."""
    ids, rows, heat, total, cap, v = k1_args
    flat_ids, flat_rows = ids.reshape(-1), rows.reshape(ids.numel(), -1)
    t, d = flat_rows.shape
    esize = flat_rows.element_size()
    n_union = int(torch.unique(flat_ids[(flat_ids >= 0) & (flat_ids < v)]).numel())
    fns = {
        "k1": (lambda: union_segsum(*k1_args, scale=scale),
               lambda: union_segsum_torch(*k1_args, scale=scale),
               lambda: k1_library(flat_ids, flat_rows, heat, total, scale)),
        "k2": (lambda: rowsparse_scatter(flat_ids, flat_rows, heat, total, v, scale=scale),
               lambda: rowsparse_scatter_torch(flat_ids, flat_rows, heat, total, v,
                                               scale=scale),
               lambda: k2_library(flat_ids, flat_rows, heat, total, v, scale)),
    }
    # least bytes each function must move: ids and rows read once, heat at
    # the union's rows, outputs written once; ops: one add per row element
    # and one scale per output element
    bounds = {"k1": bound(4 * t + esize * t * d + 4 * n_union + 4 * cap + 4 * cap * d,
                          t * d + cap * d),
              "k2": bound(4 * t + esize * t * d + 4 * n_union + 4 * v * d,
                          t * d + 2 * v * d)}
    out = {"shape": f"V={v} T={t} D={d} cap={cap} union={n_union} "
                    f"{str(flat_rows.dtype).replace('torch.', '')}"}
    for key, (kernel, plain, library) in fns.items():
        p1, m1, m2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        lib = cuda_ms(library)
        ops, dev_ms, names = profile_calls(kernel)
        b, by = bounds[key]
        out[key] = {"ms": min(m1, m2), "plain_ms": min(p1, p2), "library_ms": lib,
                    "bound_ms": b, "bound_by": by, "share": b / min(m1, m2),
                    "device_ops_per_call": ops, "device_ms_per_call": dev_ms}
        print(f"  {key.upper()} {label} {out['shape']}: kernel {m1:.4f}/{m2:.4f} ms "
              f"({b / min(m1, m2) * 100:.1f}% of the bound), plain {p1:.4f}/{p2:.4f} ms, "
              f"library {lib:.4f} ms, bound {b:.5f} ms ({by}); profiler: {ops:g} device "
              f"ops, {dev_ms:.4f} ms of device time per call ({', '.join(names)[:120]})")
        check(ops == 1, f"{key.upper()} {label}: {ops} device ops per call, want one")
    return out


def k1_scratch_bytes(k1_args, scale: float) -> tuple:
    """Device bytes one K1 call requests beyond its two outputs (the peak of
    the caching allocator's requested bytes, which a reused cached block
    does not inflate; out_ids and the scratch share one allocation, with
    up to 4 bytes of alignment between them), and what the launch plan says
    it needs."""
    ids, rows, heat, total, cap, v = k1_args
    flat_rows = rows.reshape(ids.numel(), -1)
    t, d = flat_rows.shape
    bf16 = rows.dtype == torch.bfloat16
    vec = _rows.vector_width(d, flat_rows.data_ptr(), flat_rows.element_size())
    plan = _rows.union_plan(t, d, v, cap, vec, _rows.max_blocks("union_segsum", DEV, bf16, vec))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out_ids, out_rows = union_segsum(*k1_args, scale=scale)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return peak - base - 4 * out_ids.numel() - 4 * out_rows.numel(), plan


def phase_timing(k1_args, launches_k1: int, launches_k2: int, err_k1: float,
                 err_k2: float, rng) -> list:
    ids, rows, heat, total, cap, v = k1_args
    k = 100
    # the main path's own round, kernel against plain version once more
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err_k1 = max(err_k1, check_k1("union_segsum[trainer round]", k1_args, 1.0 / k, union))
    res = {"trainer": time_k1_k2(k1_args, 1.0 / k, "trainer round")}
    hv, hk, hr, hd = SHAPES["heavy"]
    for dtype in (torch.float32, torch.bfloat16):
        hids, hrows, hheat = cohort(rng, hk, hr, hv, hd, dtype, DEV)
        args = (hids, hrows, hheat, float(N_CLIENTS), min(hv, hk * hr), hv)
        res[str(dtype)] = time_k1_k2(args, 1.0 / hk, "heavy")
        extra, plan = k1_scratch_bytes(args, 1.0 / hk)
        print(f"  K1 heavy {dtype}: {extra} bytes requested beyond the outputs (plan "
              f"{plan.scratch_bytes}: {plan.words} words and {plan.blocks} blocks; V/4 = "
              f"{hv / 4:.0f}, a V-sized int32 array {4 * hv})")
        check(extra <= plan.scratch_bytes + 4, f"K1 heavy: {extra} bytes of scratch")
        del hids, hrows, hheat, args
    tr, hf, hb = res["trainer"], res[str(torch.float32)], res[str(torch.bfloat16)]
    for key, ms_target, share_target in (("k1", K1_TARGET_MS, K1_TARGET_SHARE),
                                         ("k2", K2_TARGET_MS, K2_TARGET_SHARE)):
        met = lambda ok: "met" if ok else "missed"  # noqa: E731
        print(f"  {key.upper()} targets: trainer round {tr[key]['ms']:.4f} ms vs "
              f"<= {ms_target} ms: {met(tr[key]['ms'] <= ms_target)}; heavy f32 "
              f"{hf[key]['share'] * 100:.1f}% / bf16 {hb[key]['share'] * 100:.1f}% of "
              f"the bound vs >= {share_target * 100:.0f}%: "
              f"{met(min(hf[key]['share'], hb[key]['share']) >= share_target)}")

    def entry(key, name, source, replaces, launches, err):
        heavy = {"shape": hf["shape"].rsplit(" ", 1)[0]}
        for tag, r in (("f32", hf), ("bf16", hb)):
            heavy[tag] = {f: r[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "device_ops_per_call")}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": tr[key]["ms"],
                "plain_ms": tr[key]["plain_ms"], "bound_ms": tr[key]["bound_ms"],
                "bound_by": tr[key]["bound_by"], "library_ms": tr[key]["library_ms"],
                "device_ops_per_call": tr[key]["device_ops_per_call"], "heavy": heavy}

    return [entry("k1", "union_segsum", "src/repro_torch/kernels/csrc/union_segsum.cu",
                  "src/repro/kernels/union_segsum.py:170", launches_k1, err_k1),
            entry("k2", "rowsparse_scatter",
                  "src/repro_torch/kernels/csrc/rowsparse_scatter.cu",
                  "src/repro/kernels/heat_scatter.py:138", launches_k2, err_k2)]


# ---------------------------------------------------------------------------
# The serving path: K3, K4 and Qwen2.5-14B
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2_5_14b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
HOST_PROMPT, HOST_GEN, HOST_TOL = 256, 8, 1e-4
K3_TARGET_MS = 0.25            # bf16 K3 at the serving prefill, per launch
K4_SPLIT_TARGET_US = 19.0      # K4's split pass inside the decode step, per launch


def normal(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(DEV, dtype)


def phase_k3(rng) -> float:
    """K3 against its plain version, case by case (tolerance by dtype). The
    bf16 cases run the tensor-core kernel, the f32 ones the CUDA-core one."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("prefill", 4, 1024, 1024, 40, 8, 128, True, 0, 0, bf),
             ("prefill", 4, 1024, 1024, 40, 8, 128, True, 0, 0, f32),
             ("window", 2, 1024, 1024, 40, 8, 128, True, 300, 0, bf),
             ("window", 2, 1024, 1024, 40, 8, 128, True, 300, 0, f32),
             ("hd16", 2, 512, 512, 16, 4, 16, True, 0, 0, bf),
             ("hd32", 2, 512, 512, 16, 4, 32, True, 0, 0, bf),
             ("hd64", 2, 512, 512, 16, 4, 64, True, 0, 0, bf),
             ("mha-hd64", 2, 512, 512, 16, 16, 64, True, 0, 0, f32),
             ("non-causal", 1, 512, 512, 40, 8, 128, False, 0, 0, bf),
             ("non-causal", 1, 512, 512, 40, 8, 128, False, 0, 0, f32),
             ("ragged", 2, 1000, 1000, 40, 8, 128, True, 0, 0, bf),
             ("ragged", 1, 200, 333, 8, 2, 128, False, 0, 0, f32),
             ("continue", 2, 200, 333, 8, 2, 128, True, 0, 133, bf),
             ("window-in", 2, 512, 512, 8, 2, 128, True, 70, 0, bf)]
    worst = 0.0
    for name, b, sq, sk, h, kv, hd, causal, window, off, dtype in cases:
        q, k, v = (normal(rng, (b, sq, h, hd), dtype), normal(rng, (b, sk, kv, hd), dtype),
                   normal(rng, (b, sk, kv, hd), dtype))
        kw = dict(causal=causal, window=window, q_offset=off)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_torch(q, k, v, **kw)
        err = compare(f"flash_attention[{name}]", got.float(), want.float(), dtype)
        worst = max(worst, err)
        print(f"  K3 {name:10s} {str(dtype):14s} B={b} Sq={sq} Sk={sk} H={h} KV={kv} "
              f"hd={hd} causal={causal} window={window} q_offset={off} "
              f"max_abs_err={err:.3g}")
    return worst


def phase_k4(rng) -> float:
    """K4 against its plain version: full, part-filled and ring caches."""
    b, h, kv, hd = 4, 40, 8, 128
    s = SERVE_PROMPT + SERVE_GEN
    full = cache_slot_positions(s, s, False, DEV)
    part = cache_slot_positions(700, s, False, DEV)
    ring = cache_slot_positions(1300, 512, True, DEV)
    cases = [("decode", s, full, s - 1, 0, torch.bfloat16),
             ("decode", s, full, s - 1, 0, torch.float32),
             ("part-filled", s, part, 699, 0, torch.bfloat16),
             ("part-filled", s, part, 699, 0, torch.float32),
             ("ring", 512, ring, 1299, 512, torch.bfloat16),
             ("ring", 512, ring, 1299, 512, torch.float32),
             ("ring-window", 512, ring, 1299, 200, torch.float32),
             # every position above q_position: no valid slot, the mean of V
             ("empty", s, full, -5, 0, torch.bfloat16),
             ("empty", s, full, -5, 0, torch.float32)]
    worst = 0.0
    for name, slots, kpos, qpos, window, dtype in cases:
        q = normal(rng, (b, h, hd), dtype)
        kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
        got = flash_decode(q, kc, vc, kpos, qpos, window=window)
        want = flash_decode_torch(q, kc, vc, kpos, qpos, window=window)
        err = compare(f"flash_decode[{name}]", got.float(), want.float(), dtype)
        worst = max(worst, err)
        print(f"  K4 {name:11s} {str(dtype):14s} B={b} H={h} KV={kv} S={slots} hd={hd} "
              f"q_position={qpos} window={window} "
              f"valid={int(((kpos >= 0) & (kpos <= qpos)).sum())} "
              f"max_abs_err={err:.3g}")
    return worst


def capture_attention_inputs(cfg, params) -> dict:
    """One K3 (first prefill layer) and one K4 (last layer of the last
    decode step) input set, recorded, as copies, in an untimed run of the
    same request as [10]'s (same weights and prompt seed). The kernels are
    reached through ``layers``' module names, which this run wraps."""
    captured = {}
    copy = lambda args: tuple(a.clone() if torch.is_tensor(a) else a for a in args)  # noqa: E731

    def capture_k3(*args, **kw):
        captured.setdefault("k3", (copy(args), kw))
        return flash_attention(*args, **kw)

    def capture_k4(*args, **kw):
        captured["k4"] = (copy(args), kw)
        return flash_decode(*args, **kw)

    layers_mod.flash_attention, layers_mod.flash_decode = capture_k3, capture_k4
    try:
        serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                        device=DEV, seed=SEED, params=params)
    finally:
        layers_mod.flash_attention, layers_mod.flash_decode = flash_attention, flash_decode
    return captured


def phase_serve() -> tuple:
    """Qwen2.5-14B at its published size through ``launch.serve``. Returns
    the run's summary, its parameters, and one K3 and one K4 input set of
    the same request (``capture_attention_inputs``)."""
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    # one warm-up request at the same shapes (cuBLAS handles, lazy module
    # loading), so that the timed request is a steady one
    serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=2, device=DEV,
                    seed=SEED, params=params)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                          device=DEV, seed=SEED, params=params)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    nl = cfg.num_layers
    check(res.launches_prefill == {"flash_attention": nl, "flash_decode": 0},
          f"prefill launches {res.launches_prefill}, want {nl} of K3 and none of K4")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": nl * SERVE_GEN},
          f"decode launches {res.launches_decode}, want {nl} of K4 per step")
    check(launches == {"flash_attention": nl, "flash_decode": nl * SERVE_GEN},
          f"serving run launches {launches}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits), "non-finite logits")
    check(all(lg.shape == (SERVE_BATCH, cfg.vocab_size) for lg in res.logits),
          "logits shape")
    out = {"params": n_params, "init_s": init_s, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches}
    print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params ({cfg.dtype}), random init from seed {SEED} in {init_s:.1f} s")
    print(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT}: {res.prefill_ms:.1f} ms; decode "
          f"{SERVE_GEN} steps: {res.decode_ms_per_token:.2f} ms/token, "
          f"{res.tok_per_s:.1f} tok/s; peak memory {peak / 1e9:.2f} GB")
    print(f"  launches: prefill {res.launches_prefill}, decode {res.launches_decode}")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    return out, params, capture_attention_inputs(cfg, params)


def phase_serve_card_vs_host() -> dict:
    """The serving path at full width, 2 layers, f32, on the card and on
    the host from the same weights: logits within HOST_TOL, same tokens."""
    cfg = get_config(SERVE_ARCH).replace(num_layers=2, dtype="float32")
    card = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = transformer.make_params(cfg, device="cpu",
                                   state={k: v.cpu() for k, v in card.state_dict().items()})
    kw = dict(batch=1, prompt=HOST_PROMPT, gen=HOST_GEN, seed=SEED)
    rc = serve_mod.serve(cfg, device=DEV, params=card, **kw)
    t0 = time.perf_counter()
    rh = serve_mod.serve(cfg, device="cpu", params=host, **kw)
    host_s = time.perf_counter() - t0
    check(rc.launches_prefill["flash_attention"] == cfg.num_layers, "card run missed K3")
    check(rh.launches_prefill["flash_attention"] == 0, "host run launched a kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=HOST_TOL, atol=HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "card and host greedy tokens differ")
    print(f"  2 layers x d_model {cfg.d_model} f32, prompt {HOST_PROMPT}, {HOST_GEN} steps: "
          f"max |logit diff| {err:.3g} (tolerance {HOST_TOL}); tokens identical "
          f"{rc.tokens[0].tolist()}; host run {host_s:.1f} s")
    del card, host
    return {"max_logit_diff": err}


def attention_work(b, sq, h, kv, hd, keys, pairs, dtype, extra_bytes=0) -> tuple:
    """(bytes, flops) attention must move and do: q and o (sq rows), k and v
    (``keys`` rows) and ``extra_bytes`` moved once, and two products of
    2 * hd flops for each of ``pairs`` valid (query, key) pairs per (batch,
    head)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return (esize * 2 * b * hd * (sq * h + keys * kv) + extra_bytes,
            4 * b * h * hd * pairs)


def attention_bound(nbytes, ops, dtype) -> tuple:
    """Least time for that work: the larger of bytes at the HBM rate and
    flops at the dtype's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_attention_timing(captured, launches: dict, err_k3: float,
                           err_k4: float) -> list:
    """K3 and K4 at the serving path's own inputs: kernel, plain version,
    ``scaled_dot_product_attention`` on the same inputs (laid out and GQA
    heads repeated outside the timed call) and the bound."""
    import torch.nn.functional as F

    (q, k, v), kw3 = captured["k3"]
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    window = kw3.get("window", 0)
    want = flash_attention_torch(q, k, v, **kw3)
    err_k3 = max(err_k3, compare("flash_attention[serving prefill]",
                                 flash_attention(q, k, v, **kw3).float(), want.float(),
                                 q.dtype))
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    k3 = lambda: flash_attention(q, k, v, **kw3)                       # noqa: E731
    k3_plain = lambda: flash_attention_torch(q, k, v, **kw3)           # noqa: E731
    k3_lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    p1, m1, m2, p2 = (cuda_ms(k3_plain, 5, 1), cuda_ms(k3, 20), cuda_ms(k3, 20),
                      cuda_ms(k3_plain, 5, 1))
    lib3 = cuda_ms(k3_lib, 20)
    check(window == 0, "the serving model has no window")
    bytes3, ops3 = attention_work(b, sq, h, kvh, hd, sk, sq * (sq + 1) // 2, q.dtype)
    b3, by3 = attention_bound(bytes3, ops3, q.dtype)

    (q4, kc, vc, kpos, qpos), kw4 = captured["k4"]
    valid = (kpos >= 0) & (kpos <= qpos)
    n_valid = int(valid.sum())
    err_k4 = max(err_k4, compare("flash_decode[serving step]",
                                 flash_decode(q4, kc, vc, kpos, qpos, **kw4).float(),
                                 flash_decode_torch(q4, kc, vc, kpos, qpos, **kw4).float(),
                                 q4.dtype))
    g = q4.shape[1] // kc.shape[1]
    q4t = q4[:, :, None]
    kct, vct = kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    mask = valid[None, None, None]
    k4 = lambda: flash_decode(q4, kc, vc, kpos, qpos, **kw4)           # noqa: E731
    k4_plain = lambda: flash_decode_torch(q4, kc, vc, kpos, qpos, **kw4)  # noqa: E731
    k4_lib = lambda: F.scaled_dot_product_attention(q4t, kct, vct, attn_mask=mask)  # noqa: E731
    o1, n1, n2, o2 = cuda_ms(k4_plain), cuda_ms(k4), cuda_ms(k4), cuda_ms(k4_plain)
    lib4 = cuda_ms(k4_lib)
    hk = kc.shape[1]
    bytes4, ops4 = attention_work(q4.shape[0], 1, q4.shape[1], hk, hd, n_valid, n_valid,
                                  q4.dtype, extra_bytes=4 * kpos.numel())
    b4, by4 = attention_bound(bytes4, ops4, q4.dtype)
    ms3, ms4 = min(m1, m2), min(n1, n2)
    print(f"  K3 flash_attention B={b} S={sq} H={h} KV={kvh} hd={hd} {q.dtype} causal: "
          f"kernel {m1:.4f}/{m2:.4f} ms ({ops3 / ms3 / 1e9:.1f} TFLOP/s), plain "
          f"{p1:.4f}/{p2:.4f} ms, SDPA {lib3:.4f} ms ({ops3 / lib3 / 1e9:.1f} TFLOP/s), "
          f"bound {b3:.5f} ms ({by3}; {OPS_PER_S[q.dtype] / 1e12:.0f} TFLOP/s)")
    print(f"  K4 flash_decode B={q4.shape[0]} H={q4.shape[1]} KV={hk} S={kc.shape[2]} "
          f"valid={n_valid} {q4.dtype}: kernel {n1:.4f}/{n2:.4f} ms "
          f"({bytes4 / ms4 / 1e9:.2f} TB/s), plain {o1:.4f}/{o2:.4f} ms, SDPA "
          f"{lib4:.4f} ms ({bytes4 / lib4 / 1e9:.2f} TB/s), bound {b4:.5f} ms ({by4}; "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    check(ms3 <= K3_TARGET_MS, f"K3 at the serving prefill: {ms3:.4f} ms > the "
          f"{K3_TARGET_MS} ms target")
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:100",
         "launches": launches["flash_attention"], "max_abs_err": err_k3,
         "ms": min(m1, m2), "plain_ms": min(p1, p2), "bound_ms": b3,
         "bound_by": by3, "library_ms": lib3},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88",
         "launches": launches["flash_decode"], "max_abs_err": err_k4,
         "ms": min(n1, n2), "plain_ms": min(o1, o2), "bound_ms": b4,
         "bound_by": by4, "library_ms": lib4},
    ]


def phase_decode_profile(params, steady_ms: float) -> dict:
    """Where one decode step's time goes at the serving shape: device time
    by op over 5 warm steps (torch.profiler) against the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(SERVE_ARCH)
    api = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 1),
                         dtype=torch.int32).to(DEV)
    cache = api.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, DEV)
    logits, cache = api.prefill(params, {"tokens": toks}, cache)
    for _ in range(3):
        logits, cache = api.decode_step(params, cache, {"tokens": logits.argmax(-1).int()})
    n = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            logits, cache = api.decode_step(params, cache,
                                            {"tokens": logits.argmax(-1).int()})
        torch.cuda.synchronize()
    by_name, ops = device_times(prof)
    device_ms = sum(by_name.values()) / n / 1e3
    split_us = [t for name, t in by_name.items() if "split_kernel" in name]
    k4_ms = sum(t for name, t in by_name.items() if "split_kernel" in name
                or "merge_kernel" in name) / n / 1e3
    split_us_per_launch = sum(split_us) / (n * cfg.num_layers)
    gemm_ms = matmul_us(by_name) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    out = {"steady_ms_per_step": steady_ms, "device_ms_per_step": device_ms,
           "device_ops_per_step": ops / n, "k4_ms_per_step": k4_ms,
           "k4_split_us_per_launch": split_us_per_launch,
           "matmul_ms_per_step": gemm_ms,
           "busy_share": device_ms / steady_ms if steady_ms else None,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"  decode step: {steady_ms:.2f} ms steady (host clock, [10]); device busy "
          f"{device_ms:.3f} ms ({device_ms / steady_ms * 100:.1f}%), {ops / n:.0f} device "
          f"ops per step; matmuls {gemm_ms:.3f} ms, K4 {k4_ms:.4f} ms (split pass "
          f"{split_us_per_launch:.2f} us per launch); weight-read bound "
          f"{out['weight_read_bound_ms']:.3f} ms ({weight_bytes / 1e9:.2f} GB)")
    for name, t in top:
        print(f"    {t / n / 1e3:.4f} ms/step  {name[:90]}")
    check(split_us_per_launch <= K4_SPLIT_TARGET_US, f"K4's split pass in the decode "
          f"step: {split_us_per_launch:.2f} us > the {K4_SPLIT_TARGET_US} us target")
    return out


def device_times(prof) -> tuple:
    """Device microseconds by kernel name, and the number of device ops, of
    a torch.profiler run."""
    from torch.autograd import DeviceType

    by_name, ops = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name, ops


def matmul_us(by_name: dict) -> float:
    # cuBLAS's kernels: nvjet_* on Hopper, *gemm*/*gemv* elsewhere
    return sum(t for name, t in by_name.items()
               if any(w in name.lower() for w in ("nvjet", "gemm", "gemv")))


def phase_prefill_profile(params, prefill_ms: float) -> dict:
    """Where one prefill's time goes at the serving shape: device time by op
    over one warm prefill of 4 x 1,024 tokens (torch.profiler), K3's total
    over its launches, the matmuls', against the unprofiled prefill of [10]."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(SERVE_ARCH)
    api = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32).to(DEV)
    cache = api.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, DEV)
    api.prefill(params, {"tokens": toks}, cache)       # warm
    cache = api.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
    by_name, ops = device_times(prof)
    device_ms = sum(by_name.values()) / 1e3
    k3 = [t for name, t in by_name.items() if "attention_kernel" in name]
    k3_ms = sum(k3) / 1e3
    gemm_ms = matmul_us(by_name) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"prefill_ms": prefill_ms, "device_ms": device_ms, "device_ops": ops,
           "k3_ms": k3_ms, "k3_ms_per_launch": k3_ms / cfg.num_layers,
           "matmul_ms": gemm_ms, "other_ms": device_ms - k3_ms - gemm_ms,
           "busy_share": device_ms / prefill_ms if prefill_ms else None}
    print(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT}: {prefill_ms:.1f} ms (host clock, [10]); "
          f"device busy {device_ms:.2f} ms ({device_ms / prefill_ms * 100:.1f}%), {ops} "
          f"device ops; matmuls {gemm_ms:.2f} ms, K3 {k3_ms:.3f} ms "
          f"({k3_ms / cfg.num_layers * 1e3:.1f} us x {cfg.num_layers}), the rest "
          f"{out['other_ms']:.2f} ms")
    for name, t in top:
        print(f"    {t / 1e3:.4f} ms  {name[:90]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: off for matmuls and cuDNN (full float32 everywhere)")
    built = _build.build()
    print(f"[1] kernels built in {built.seconds:.1f} s into {built.directory}")
    for name, log in built.logs.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error")):
                print(f"    {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    print("[2] K1 union_segsum vs plain version")
    err_k1 = phase_k1(rng)
    print("[3] K2 rowsparse_scatter vs plain version")
    err_k2 = phase_k2(rng)

    print("[4] main path: LR FedSubAvg at MovieLens-1M width")
    t0 = time.perf_counter()
    ds = make_movielens_like(num_clients=N_CLIENTS, num_items=3706,
                             mean_samples=165, seed=SEED)
    print(f"  data: {ds.stats()} V={ds.num_features} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(ds.num_features == 37_069, "V must be 37,069")
    runs, launches_k1, captured = phase_main_path(ds)
    k1_args = captured["args"]
    launches_k2, err_k2_path = phase_k2_path(k1_args)

    print("[5] card vs host, 5 rounds")
    phase_card_vs_host(ds)

    print("[6] kernel times")
    kernels = phase_timing(k1_args, launches_k1, launches_k2, err_k1,
                           max(err_k2, err_k2_path), rng)

    print("[7] where a fedsubavg round's time goes")
    phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"])

    print("[8] K3 flash_attention vs plain version")
    err_k3 = phase_k3(rng)
    print("[9] K4 flash_decode vs plain version")
    err_k4 = phase_k4(rng)
    print(f"[10] serving path: {SERVE_ARCH} at its published size")
    served, params, captured = phase_serve()
    print("[11] card vs host, 2 layers at full width, f32")
    phase_serve_card_vs_host()
    print("[12] K3 and K4 times at the serving path's inputs")
    kernels += phase_attention_timing(captured, served["launches"], err_k3, err_k4)
    print("[13] where a decode step's time goes")
    phase_decode_profile(params, served["decode_ms_per_token"])
    print("[14] where a prefill's time goes")
    phase_prefill_profile(params, served["prefill_ms"])
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
