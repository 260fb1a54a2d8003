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
15. DIN FedSubAvg at the width of the DIN paper's Amazon Electronics
    (63,001 goods, ~9 samples per user; 2,000 of its 192,403 users, a cut
    printed on a ``reduced:`` line; emb 18, hidden 36): fedsubavg and
    fedavg, 20 rounds each, as in [4]; K1 (D = 18) must serve every round
    once, and is held to its plain version on one round's inputs
16. the same for the LSTM on Sent140-like data (1,000 clients, a
    20,000-word vocabulary, 24 tokens; emb 25, hidden 100, two cells):
    K1 at D = 25
17. card against host: DIN and the LSTM on 200 clients, fedsubavg and
    fedavg, 3 rounds each; losses and parameters within 1e-5
18. where a DIN and an LSTM fedsubavg round's time goes, as [7], and K1's
    times at each round's own inputs, as [6]
19. the paper's Table 2 algorithms at [4]'s configuration, 20 rounds each
    as in [4]: scaffold (``server_lr`` 1.0) and fedadam (0.03) on the
    sparse plan, where K1 must serve every round (no heat, scale 1/K, held
    to its plain version on one scaffold round's inputs); the same two and
    fedsubavg on the dense plan and central SGD, where K1 must not launch.
    Train loss falls and AUC > 0.5 in every run; their order is printed.
    Where a round's time goes on each new path, as [7]
20. private and weighted heat: fedsubavg on the sparse plan for 10 rounds
    under randomized response, randomized response with weights and exact
    heat with weights (K1 every round, losses finite); the heat's resolve
    time on the host, its numpy peak (tracemalloc) and the process's peak
    resident memory (getrusage)
21. card against host: 3 rounds of sparse scaffold and fedadam, dense
    fedsubavg, central and randomized-response fedsubavg on 200 clients of
    [4]'s data; losses, parameters and optimizer slots within 1e-5
22. the paper's Table 2 and Table 3 protocols (``tools/paper_tables.py``)
    on the dense and the sparse plan, printed as tables
23. ``ReplicatedLocal x RowSparseTransport`` (``sparse_local="replicated"``:
    K dense replicas, rows gathered from their deltas) through the trainer
    at [4]'s configuration, fedsubavg and fedavg, 20 rounds each as in [4];
    K1 must serve every round and is held to its plain version on one
    round's inputs; losses against [4]'s submodel-replica runs of the same
    seed (the same deltas on the touched rows); one round's profile, as [7]
24. int8 rows (``sparse_int8=True``) through the trainer at [4]'s
    configuration, alone and with top-16, on the submodel and the replicated
    plan, 20 rounds each; K1 every round, loss falls, AUC > 0.5; uplink
    bytes per round beside the f32 plans'; unbiased rounding on the card
    (the mean of 256 dequantised draws against the rows, in standard errors)
25. ``make_round_step`` on the LSTM at [16]'s width in its four modes,
    fedsgd with 4 microbatches, an int8 ``FedSgdLocal`` plan and an int8
    ``sparse_replicated`` plan, 3 steps each (K1 once per step on the two
    ``sparse_replicated`` plans only, held to its plain version on an int8
    step at D = 25); ``debug_checks``
    on and off equal bit for bit, a planted unsorted ``sub_ids`` raises;
    gather before backward with the table widened to V = 2^22: the step's
    peak device memory stays below the parameters plus one (V, D) table
26. card against host, 3 rounds on 200 clients of [4]'s data: the
    replicated plan, int8 rows with the noise drawn on the host and copied
    to the card (submodel and replicated), ``make_round_step``
    fedsgd, sparse and int8 ``sparse_replicated`` (the noise from the
    host) on the LSTM at 200 clients of [16]'s data; losses and
    parameters within 1e-5, except the int8 plan's table, which is held
    step by step instead (each step's int8 rounding and K1 on the card
    against the host's, from the host's deltas, within 1e-5: a ulp of
    difference between the two sides' deltas can move a rounding by one
    quantum); Example 1's condition numbers (``core/preconditioner.py``)
27. round telemetry at [4]'s configuration: 20 rounds through ``run`` and
    20 through ``run(engine=True)``, telemetry on (a JSONL ``TraceSink``),
    off and off again, K1 20 of 20 per run; on against off: the records
    within 1e-6 and the parameters within 1e-5 (K1's atomic order on rows
    scaled by up to N / n_m moves them by a few 1e-6 between any two runs;
    the second off run shows it); every
    round's heat histogram sums to its union, no id dropped at the pow2
    capacity; the sink reads back; ``compile_time`` booked in exactly the
    stretches with a first dispatch; ms and device ops per round on and
    off; [25]'s sparse ``FedSgdLocal`` LSTM step (no K1) on and off bit for
    bit under deterministic algorithms; a planted capacity of 16 through
    ``build_round_step``: the drop counts equal a numpy count
28. ``run(2, profile_dir=...)``: one trace file, its ``rounds[a:b]`` range
    and as many K1 events as K1's launch counter rose by
29. the buffered-async engine at [4]'s configuration: (a) zero delay with
    ``buffer_size = K`` against ``run_rounds(10)`` within 1e-5 (K1 10 of
    10 fires, the next numpy draw equal); (b) 20 lognormal waves with
    stragglers and dropouts, 25-arrival buffers, polynomial staleness and
    EMA heat: K1 once per fire, each fire's staleness histogram sums to 25,
    loss falls, AUC > 0.5, rows only dropped clients touch unchanged; ms
    per event and per fire, device ops per dispatch group, arrival group
    and fire (a profiled rerun), K1 at the fire's shape; (c) the same with
    100-arrival buffers and constant weights
30. card against host: (b)'s schedule over 6 waves of K = 20 on 200
    clients with telemetry and a non-binding top-k: losses, parameters,
    EMA heat and telemetry within 1e-5 (integers equal); a mid-run
    checkpoint saved on the card and resumed on the host equals the
    uninterrupted host run within 1e-5
31. cohort-sharded rounds (``FederatedTrainer(mesh=...)``): LR at [4]'s
    configuration, fedsubavg and fedavg (``auto``: psum) and fedsubavg
    with ``combine="union"``, 20 rounds each, on 1 rank (NCCL), 2 and 4
    ranks (gloo on the card's tensors: the machine has one card and NCCL
    refuses two ranks on one device), spawned with a bounded join; K1 once
    per rank per round under psum, once per rank more under union (the
    partial, then one call per further rank); losses, train loss and
    parameters within 1e-5 of the unsharded trainer on the card, every
    rank's parameters equal to rank 0's bit for bit; ms per round per
    world size (ranks sharing one card measure the machinery, not a
    speed-up); K1 at the shard partial's and the union combine's shapes
32. DIN at [15]'s configuration on 2 ranks, 10 rounds: ``auto`` picks the
    union combine at 63,001 x 18 f32, K1 twice per rank per round, as [31]
33. ``make_round_step`` on 2 ranks on [25]'s LSTM inputs: flat fedsgd and
    sparse, replicated, sparse_replicated and a 3-client cohort with
    ``debug_checks``, 3 steps each against the unsharded step on the card
    within 1e-5; every rank's collective counters equal
    ``round_collective_budget``'s components in every step
34. K3's backward (``flash_attention_bwd``) against its plain version on
    the card: the training shape (B 16, S 128, H 40, KV 8, hd 128) and
    ragged, windowed, GQA, continuation and non-causal shapes, f32 and
    bf16 (2e-5 and 2e-2, as [8]); ``FlashAttention`` under
    ``torch.func.grad`` and ``vmap(grad)`` over 3 clients against autograd
    of K3's plain version, one backward launch per call
35. the LLM main path: ``repro_torch.launch.train.train`` at Qwen2.5-14B's
    published widths (d_model 5,120, 40 / 8 heads, d_ff 13,824, vocab
    152,064, QKV bias) with 4 of its 48 layers (a cut printed on a
    ``reduced:`` line), f32, weights from seed 0, on
    ``make_lm_federated(256 clients, 128 tokens, 4 samples, zipf 1.3)``,
    cohort 16, lr 0.05: FedSgdLocal under fedsubavg and fedavg on the dense
    and the row-sparse transport, 10 rounds each; K3 and its backward 4
    times per round, K1 never; losses finite; ms per round, peak device
    memory, uplink bytes per round on the sparse transport
36. card against host: 1 layer at full width, cohort 2, 32 tokens, one
    round per transport from the same weights; loss and parameters within
    1e-4 (the sum order of 5,120- and 13,824-long f32 dot products, as [11])
37. ``make_round_step`` on the LLM at the reference's ``100m`` scale in its
    four modes, 3 steps each: K1 once per ``sparse_replicated`` step and
    never otherwise; the same at ``tiny`` on the card and on the host,
    losses and parameters within 1e-5
38. where a fedsubavg dense round of [35] goes (torch.profiler): device
    ops, busy share, device ms in matmuls, K3, K3's backward and the rest;
    K3 and its backward at the training shape by CUDA events beside their
    plain versions, SDPA (for the backward: autograd of
    ``scaled_dot_product_attention``, its forward subtracted) and the bound

It ends with the kernels as one JSON line (K1's entry also carries its
launches on the LR, DIN and LSTM paths, on the scaffold and fedadam paths,
on the replicated and int8 paths, in ``make_round_step``, on the telemetry
runs and the async fires, per rank on the mesh and on [37]'s LLM steps,
and its times at the DIN and LSTM rounds, at an async fire and at the
mesh's partial and union combine; K3's its launches on the training path
and its times at the training shape; K3-backward's entry its launches on
[35] and its share of a round), the card line and, last,
``{"ok": true, "device": {...}}``.

"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.federated import ArrivalSim, BufferedAsyncServerUpdate  # noqa: E402
from repro_torch.telemetry import TraceSink, read_events, telemetry_to_host  # noqa: E402
from repro_torch.data.batching import pooled_batches  # noqa: E402
from repro_torch.data.synthetic import (make_amazon_like,  # noqa: E402
                                        make_movielens_like, make_sent140_like)
from repro_torch.core.preconditioner import (condition_number,  # noqa: E402
                                             preconditioned_hessian)
from repro_torch.data.batching import sample_cohort_batch  # noqa: E402
from repro_torch.federated.plan import (CohortSharding, FedSgdLocal,  # noqa: E402
                                        RoundPlan, RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal, build_round_step,
                                        resolve_plan, round_collective_budget)
from repro_torch.launch.mesh import make_cohort_mesh, spawn_ranks  # noqa: E402
from repro_torch.federated.simulation import make_round_step  # noqa: E402
from repro_torch.core.algorithms import ServerState  # noqa: E402
from repro_torch.sparse import compress  # noqa: E402
from repro_torch.federated.server import FederatedTrainer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build, _rows  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttention,  # noqa: E402
                                                 flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_torch)
from repro_torch.data.synthetic import make_lm_federated  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
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
from repro_torch.federated import plan as plan_mod  # noqa: E402
from repro_torch.sparse import aggregate as aggregate_mod  # noqa: E402
from repro_torch.sparse.aggregate import aggregate_rowsparse_dense, pick_combine  # noqa: E402
from repro_torch.sparse.rowsparse import RowSparse, unique_ids_padded  # noqa: E402
from tools.aggregation_times import N_CLIENTS, SHAPES, cohort, cuda_ms  # noqa: E402
from tools.paper_tables import DIN_DATA, print_tables, tables, task_bindings  # noqa: E402

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


#: [15]: the DIN paper's Amazon Electronics (Zhou et al., KDD 2018, Table 1:
#: 192,403 users, 63,001 goods, 1,689,188 samples, ~9 per user): DIN_DATA
DIN_REDUCED = ("clients 192,403 -> 2,000 (the host generator loops per client over "
               "a 63,001-long distribution); goods, samples per client and widths as "
               "published")
#: [16]: the repository's Sent140-like shape (24 tokens, ~30 samples per client)
LSTM_DATA = dict(num_clients=1000, vocab=20000, seq_len=24, mean_samples=30, seed=SEED)
LSTM_REDUCED = ("none against a published size: the repository gives none for its "
                "Sent140-like data, so 1,000 clients and a 20,000-word vocabulary are "
                "this script's choice; emb 25, hidden 100, two cells as in the repository")


def make_trainer(ds, alg: str, device, plan=None, telemetry: bool = False, sink=None,
                 mesh=None, **fed_kw) -> FederatedTrainer:
    """The paper's model for the dataset's task at the repository's widths
    (``tools/paper_tables.py::task_bindings``; random leaves drawn on the
    host from ``SEED``, so the card and the host start alike), K = 100, on
    the sparse plan unless ``fed_kw`` says otherwise. Telemetry is off
    unless asked for, so that the phases timing rounds run the program
    they timed before the trainer's default turned it on."""
    cfg = FedConfig(**{**dict(num_clients=ds.num_clients, clients_per_round=100,
                              local_iters=5, local_batch=5, lr=0.5, algorithm=alg,
                              sparse=True, seed=SEED), **fed_kw})
    make_params, loss, predict = task_bindings(ds, SEED)
    return FederatedTrainer(ds, make_params, loss, cfg, predict_fn=predict, plan=plan,
                            device=device, telemetry=telemetry, sink=sink, mesh=mesh)


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
           "capacity": tr._last_capacity,
           "comm": tr.comm_summary() if tr.comm_log else None}
    print(f"  {label}: per-round loss {[round(x, 5) for x in losses]}")
    print(f"  {label}: after 20 rounds train_loss={rec.train_loss:.5f} "
          f"auc={rec.test_metric:.5f}; ms/round run_round median "
          f"{out['steady_ms_per_round']:.2f}, run(engine) {out['run_ms_per_round']:.2f}")
    return out


@contextlib.contextmanager
def capture_k1(captured: dict):
    """Record the inputs of the aggregation's K1 calls (the last one stays)
    in ``captured``; the calls still launch K1."""
    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return union_segsum(*args, **kw)

    aggregate_mod.union_segsum = capture
    try:
        yield
    finally:
        aggregate_mod.union_segsum = union_segsum


def phase_main_path(ds) -> tuple:
    """The trainer at full width. Returns the per-run summaries, the K1
    launch count of the run and the K1 inputs of one fedsubavg round."""
    captured = {}
    union_segsum.launches = 0
    rowsparse_scatter.launches = 0
    runs = {}
    with capture_k1(captured):
        runs["fedsubavg"] = drive(make_trainer(ds, "fedsubavg", DEV), "fedsubavg")
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


def phase_deep_path(ds) -> tuple:
    """[15] and [16]: DIN or the LSTM at the repository's widths through the
    trainer, fedsubavg then fedavg, 20 rounds each; K1 must serve every
    round once. K1 is then held to its plain version on the inputs of one
    fedsubavg round (ids exact, f32 2e-5). Returns the runs, K1's launches
    on this path, the captured inputs and K1's error on them."""
    captured = {}
    union_segsum.launches = 0
    runs = {}
    with capture_k1(captured):
        runs["fedsubavg"] = drive(make_trainer(ds, "fedsubavg", DEV), f"{ds.task} fedsubavg")
    check(union_segsum.launches == 20, f"K1 served {union_segsum.launches}/20 rounds")
    runs["fedavg"] = drive(make_trainer(ds, "fedavg", DEV), f"{ds.task} fedavg")
    launches = union_segsum.launches
    check(launches == 40, f"K1 served {launches}/40 rounds")
    print(f"  {ds.task}: AUC after 20 rounds fedsubavg {runs['fedsubavg']['auc']:.5f}, "
          f"fedavg {runs['fedavg']['auc']:.5f}; K1 {launches} launches in 40 rounds")
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1(f"union_segsum[{ds.task} round]", args, scale, union)
    print(f"  K1 at a {ds.task} fedsubavg round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} max_abs_err={err:.3g}")
    return runs, launches, captured, err


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


def slots(state) -> tuple:
    """The optimizer's slot dicts of a ServerState (none, one or two)."""
    return (state.opt,) if isinstance(state.opt, dict) else tuple(state.opt)


def phase_card_vs_host(ds, rounds: int = 5, cases=(("fedsubavg", "fedsubavg", {}),
                                                    ("fedavg", "fedavg", {}))) -> dict:
    """``rounds`` rounds of each ``(label, algorithm, FedConfig flags)`` on
    the card and on the host: losses, parameters and optimizer slots within
    1e-5."""
    out = {}
    for label, alg, kw in cases:
        card, host = make_trainer(ds, alg, DEV, **kw), make_trainer(ds, alg, "cpu", **kw)
        lc = [card.run_round() for _ in range(rounds)]
        lh = [host.run_round() for _ in range(rounds)]
        dl = max(abs(a - b) for a, b in zip(lc, lh))
        check(np.allclose(lc, lh, rtol=1e-5, atol=1e-5),
              f"{label}: card and host losses differ by {dl}")
        dp = 0.0
        card_trees = (card.state.params,) + slots(card.state)
        host_trees = (host.state.params,) + slots(host.state)
        check(len(card_trees) == len(host_trees), f"{label}: optimizer slots differ")
        for ct, ht in zip(card_trees, host_trees):
            for name, p in ct.items():
                q = ht[name]
                dp = max(dp, float((p.cpu() - q).abs().max()))
                check(torch.allclose(p.cpu(), q, rtol=1e-5, atol=1e-5),
                      f"{label}: card and host '{name}' differ by {dp}")
        out[label] = {"max_loss_diff": dl, "max_param_diff": dp}
        print(f"  {ds.task} {label}: {rounds} rounds card vs host: max |loss diff| "
              f"{dl:.3g}, max |param or slot diff| {dp:.3g} "
              f"({len(card_trees) - 1} slot dicts)")
    return out


#: [19]: the paper's Table 2 algorithms at [4]'s configuration, with the
#: server step sizes of ``benchmarks/bench_table2.py``
PROTOCOL_RUNS = (("scaffold sparse", "scaffold", dict(sparse=True, server_lr=1.0)),
                 ("fedadam sparse", "fedadam", dict(sparse=True, server_lr=0.03)),
                 ("scaffold dense", "scaffold", dict(sparse=False, server_lr=1.0)),
                 ("fedadam dense", "fedadam", dict(sparse=False, server_lr=0.03)),
                 ("fedsubavg dense", "fedsubavg", dict(sparse=False)),
                 ("central", "central", dict(sparse=False)))


def phase_protocol_paths(ds) -> tuple:
    """[19]: each run driven as in [4] with K1's count set to 0 just before
    it and read just after: 20 launches on the sparse plan, none on the
    dense plan or central. K1 is held to its plain version on the inputs of
    one scaffold round (no heat, scale 1/K). Returns the runs, K1's launches
    by run and its error there."""
    runs, launches, captured = {}, {}, {}
    for label, alg, kw in PROTOCOL_RUNS:
        ctx = capture_k1(captured) if label == "scaffold sparse" else contextlib.nullcontext()
        union_segsum.launches = 0
        with ctx:
            runs[label] = drive(make_trainer(ds, alg, DEV, **kw), label)
        launches[label] = union_segsum.launches
        want = 20 if kw["sparse"] else 0
        check(launches[label] == want, f"{label}: K1 launched {launches[label]} times "
              f"in 20 rounds, want {want}")
    order = sorted(runs, key=lambda r: -runs[r]["auc"])
    print("  AUC after 20 rounds (a finding, not asserted): "
          + ", ".join(f"{r} {runs[r]['auc']:.5f}" for r in order))
    print("  K1 launches: " + ", ".join(f"{r} {n}" for r, n in launches.items()))
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    check(args[2] is None and scale == 1.0 / 100, "scaffold's K1 call: no heat, scale 1/K")
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1("union_segsum[scaffold round]", args, scale, union)
    print(f"  K1 at a scaffold round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} no heat max_abs_err={err:.3g}")
    for label, alg, kw in PROTOCOL_RUNS:
        if label != "scaffold dense":       # the dense plan's twin of fedadam's
            phase_profile(ds, runs[label]["steady_ms_per_round"], label=label, alg=alg,
                          **kw)
    return runs, launches, err


#: [20]: heat estimators on the sparse plan
HEAT_RUNS = (("randomized response", dict(heat_estimator="randomized_response")),
             ("randomized response, weighted", dict(heat_estimator="randomized_response",
                                                    weighted=True)),
             ("exact, weighted", dict(weighted=True)))


def phase_private_heat(ds) -> dict:
    """[20]: the heat's resolve on the host, timed, with its numpy peak
    (tracemalloc, which numpy reports to) and the process's peak resident
    memory after it (getrusage; a high-water mark of the whole run), then
    10 fedsubavg rounds on the sparse plan with that heat (K1 once per
    round, losses finite; their course and the AUC are printed)."""
    out = {}
    for label, kw in HEAT_RUNS:
        cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, seed=SEED, **kw)
        tracemalloc.start()
        t0 = time.perf_counter()
        heat = FederatedTrainer._resolve_heat(ds, cfg)
        resolve_s = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        union_segsum.launches = 0
        tr = make_trainer(ds, "fedsubavg", DEV, **kw)
        check(np.array_equal(tr.heat.counts, heat.counts), f"{label}: heat differs")
        losses = [tr.run_round() for _ in range(10)]
        launches = union_segsum.launches
        auc = tr.evaluate()
        check(launches == 10, f"{label}: K1 launched {launches} times in 10 rounds")
        # loss and AUC are findings here: weighted randomized response can
        # clamp a cold row's estimate to 1 against weights ~165, a factor
        # of up to W ~ 1.0M on that row's update
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
        out[label] = {"resolve_s": resolve_s, "numpy_peak_bytes": peak,
                      "maxrss_bytes": maxrss, "auc": auc, "losses": losses}
        print(f"  {label}: heat resolved in {resolve_s:.2f} s on the host (traced), numpy "
              f"peak {peak / 2**20:.1f} MiB, process peak RSS {maxrss / 2**30:.2f} GiB; "
              f"total {heat.total:.0f}, min {heat.counts.min():.3f}, max "
              f"{heat.counts.max():.1f}; 10 rounds loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, AUC {auc:.5f}, K1 {launches} launches")
    return out


def phase_profile(ds, steady_ms: float, n: int = 5, label: str = "fedsubavg",
                  alg: str = "fedsubavg", **fed_kw) -> dict:
    """Where one round's time goes: host sampling, device kernel time and
    launches per round (torch.profiler over ``n`` warm rounds), and the
    device's busy share of the unprofiled steady round time. K1 must be in
    a sparse round, once."""
    from torch.autograd import DeviceType

    tr = make_trainer(ds, alg, DEV, **fed_kw)
    for _ in range(3):
        tr.run_round()
    cfg = tr.cfg
    sample = (tr._sample_sparse_cohort if tr.plan is not None else
              lambda: pooled_batches(ds, cfg.local_iters,
                                     cfg.local_batch * cfg.clients_per_round, tr.np_rng))
    t0 = time.perf_counter()
    for _ in range(5):
        sample()
    sample_ms = (time.perf_counter() - t0) / 5 * 1e3
    prof, by_name, launches = device_profile(lambda: [tr.run_round() for _ in range(n)])
    device_ms = sum(by_name.values()) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"host_sampling_ms_per_round": sample_ms,
           "device_kernel_ms_per_round": device_ms,
           "device_ops_per_round": launches / n,
           "steady_ms_per_round": steady_ms,
           "device_busy_share": device_ms / steady_ms if device_ms else None,
           "top_device_ops_ms_per_round": [(k[:90], v / n / 1e3) for k, v in top]}
    print(f"  {ds.task} {label} round: {steady_ms:.2f} ms steady; host sampling "
          f"{sample_ms:.2f} ms; device ops {launches / n:.0f}/round, "
          f"{device_ms:.3f} ms busy ({(out['device_busy_share'] or 0) * 100:.1f}%)")
    for name, ms in out["top_device_ops_ms_per_round"]:
        print(f"    {ms:.4f} ms/round  {name}")
    k1 = {name: us for name, us in by_name.items() if "union_segsum_kernel" in name}
    if not tr._is_sparse:
        check(not k1, f"K1 in a {label} round: {sorted(k1)}")
        return out
    check(len(k1) == 1, f"K1 in the round: {sorted(k1)}")
    # K1 launches once per round ([4], [15], [16]): its device ops per call
    # are its kernels per round
    k1_ops = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "union_segsum_kernel" in e.name)
    out["k1_device_ops_per_round"] = k1_ops / n
    out["k1_device_ms_per_round"] = sum(k1.values()) / n / 1e3
    print(f"    K1 in the round: {out['k1_device_ms_per_round']:.4f} ms/round in "
          f"{k1_ops / n:g} device ops  {next(iter(k1))[:90]}")
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
    if heat is None:
        f = torch.full(u.shape, scale, device=DEV)
    else:
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


#: the kernels whose wrappers count their launches, by the name of their one
#: device op per launch ([6] checks that it is one)
COUNTED_KERNELS = (("union_segsum_kernel", union_segsum),
                   ("rowsparse_scatter_kernel", rowsparse_scatter))


def device_profile(fn, attempts: int = 5, calls: int = 1) -> tuple:
    """``(prof, device us by kernel name, device ops)`` of torch.profiler
    around ``fn()``, which makes ``calls`` identical calls with one kernel
    sequence each, or, with ``calls=1``, one piece of work (rounds: their
    device ops vary with the data, by a few in an LSTM round's 11,300).

    Short profiles have come back empty, or one K1 event short of five
    calls, while the launch counters showed the work ran: the first
    kernels after the profiler starts can go unrecorded. So the host waits
    50 ms inside the profile before ``fn()``, and a trace stands only if it
    holds exactly as many K1 and K2 events as their launch counters rose by
    (one device op per launch, [6]) and its device events split evenly over
    the calls. A trace that fails is the profiler's miss, not a
    measurement; if none stands after ``attempts``, the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        before = [w.launches for _, w in COUNTED_KERNELS]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
        by_name, ops = device_times(prof)
        counted = [(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                        and name in e.name), w.launches - b)
                   for (name, w), b in zip(COUNTED_KERNELS, before)]
        if ops > 0 and ops % calls == 0 and all(a == b for a, b in counted):
            return prof, by_name, ops
        print(f"    (the profiler recorded {ops} device events over {calls} calls, and "
              f"K1/K2 events against launches {counted}: profiling again)")
        time.sleep(0.2)
    check(False, f"no profile stood after {attempts} attempts")


def profile_calls(fn, n: int = 5) -> tuple:
    """Device ops and device milliseconds per call of ``fn``, and the device
    ops' names (torch.profiler over ``n`` warm calls)."""
    fn()
    _, by_name, ops = device_profile(lambda: [fn() for _ in range(n)], calls=n)
    return ops / n, sum(by_name.values()) / n / 1e3, sorted(by_name)


def time_k1_k2(k1_args, scale: float, label: str, keys=("k1", "k2"),
               profiled=None, profile: bool = True) -> dict:
    """K1 and K2 on one cohort: kernel, plain version and library call by
    CUDA events in turns (plain / kernel / kernel / plain), the bound, and
    device ops and device time per call from the profiler. ``profiled``
    gives those two by key where a round's profile has measured them
    already (a short profile right after a round's was seen to record no
    device events); ``profile=False`` leaves them out (not measured)."""
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
    # least bytes each function must move: ids and rows read once, heat (if
    # any) at the union's rows, outputs written once; ops: one add per row
    # element and one scale per output element
    heat_bytes = 4 * n_union if heat is not None else 0
    bounds = {"k1": bound(4 * t + esize * t * d + heat_bytes + 4 * cap + 4 * cap * d,
                          t * d + cap * d),
              "k2": bound(4 * t + esize * t * d + 4 * n_union + 4 * v * d,
                          t * d + 2 * v * d)}
    out = {"shape": f"V={v} T={t} D={d} cap={cap} union={n_union} "
                    f"{str(flat_rows.dtype).replace('torch.', '')}"}
    for key in keys:
        kernel, plain, library = fns[key]
        p1, m1, m2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        lib = cuda_ms(library)
        if not profile:
            ops, dev_ms, names = None, None, []
        elif profiled is None:
            ops, dev_ms, names = profile_calls(kernel)
        else:
            (ops, dev_ms), names = profiled[key], ["from the round's profile"]
        b, by = bounds[key]
        out[key] = {"ms": min(m1, m2), "plain_ms": min(p1, p2), "library_ms": lib,
                    "bound_ms": b, "bound_by": by, "share": b / min(m1, m2),
                    "device_ops_per_call": ops, "device_ms_per_call": dev_ms}
        prof = (f"profiler: {ops:g} device ops, {dev_ms:.4f} ms of device time per call "
                f"({', '.join(names)[:120]})" if profile else "not profiled")
        print(f"  {key.upper()} {label} {out['shape']}: kernel {m1:.4f}/{m2:.4f} ms "
              f"({b / min(m1, m2) * 100:.1f}% of the bound), plain {p1:.4f}/{p2:.4f} ms, "
              f"library {lib:.4f} ms, bound {b:.5f} ms ({by}); {prof}")
        check(not profile or ops == 1,
              f"{key.upper()} {label}: {ops} device ops per call, want one")
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
    reached through ``FlashAttention.forward`` for K3 and ``layers``' name
    for K4, which this run wraps."""
    captured = {}
    copy = lambda args: tuple(a.clone() if torch.is_tensor(a) else a for a in args)  # noqa: E731
    k3_forward = FlashAttention.forward

    def capture_k3(q, k, v, causal, window, q_offset, query_chunk, kv_chunk):
        captured.setdefault("k3", (copy((q, k, v)), dict(
            causal=causal, window=window, q_offset=q_offset, query_chunk=query_chunk,
            kv_chunk=kv_chunk)))
        return k3_forward(q, k, v, causal, window, q_offset, query_chunk, kv_chunk)

    def capture_k4(*args, **kw):
        captured["k4"] = (copy(args), kw)
        return flash_decode(*args, **kw)

    FlashAttention.forward, layers_mod.flash_decode = staticmethod(capture_k3), capture_k4
    try:
        serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                        device=DEV, seed=SEED, params=params)
    finally:
        FlashAttention.forward, layers_mod.flash_decode = staticmethod(k3_forward), flash_decode
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
        # a record_function range has a device-side span too: not an op
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("async_engine.")):
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


def phase_replicated(ds, submodel_runs) -> tuple:
    """[23]: the replicated plan through the trainer, fedsubavg and fedavg,
    each driven as in [4] with K1's count set to 0 just before it and read
    just after (20 of 20). Its deltas on the touched rows are the submodel
    plan's, so its losses are [4]'s but for the atomics' sum order in K1.
    Returns the runs, K1's launches by run and K1's error on one round."""
    runs, launches, captured = {}, {}, {}
    for alg in ("fedsubavg", "fedavg"):
        ctx = capture_k1(captured) if alg == "fedsubavg" else contextlib.nullcontext()
        union_segsum.launches = 0
        with ctx:
            runs[alg] = drive(make_trainer(ds, alg, DEV, sparse_local="replicated"),
                              f"{alg} replicated")
        launches[alg] = union_segsum.launches
        check(launches[alg] == 20, f"{alg} replicated: K1 served {launches[alg]}/20 rounds")
        mine = runs[alg]["round_loss"] + [runs[alg]["train_loss"]]
        theirs = submodel_runs[alg]["round_loss"] + [submodel_runs[alg]["train_loss"]]
        diff = max(abs(a - b) for a, b in zip(mine, theirs))
        print(f"  {alg}: replicated against [4]'s submodel replicas, 10 round losses and "
              f"the train loss after 20: max |diff| {diff:.3g}; AUC "
              f"{runs[alg]['auc']:.5f} against {submodel_runs[alg]['auc']:.5f}")
        check(diff <= 1e-4, f"{alg}: replicated and submodel losses differ by {diff}")
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1("union_segsum[replicated round]", args, scale, union)
    print(f"  K1 at a replicated fedsubavg round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} max_abs_err={err:.3g}")
    phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"],
                  label="fedsubavg replicated", sparse_local="replicated")
    return runs, launches, err


#: [24]: int8 rows on both replica plans, with and without top-16
INT8_RUNS = (("int8", {}), ("int8 top-16", dict(sparse_topk=16)),
             ("int8 replicated", dict(sparse_local="replicated")),
             ("int8 top-16 replicated", dict(sparse_topk=16, sparse_local="replicated")))


def int8_unbiased(rng, draws: int = 256) -> tuple:
    """Unbiased rounding on the card: ``draws`` quantisations of one cohort's
    rows (16 clients x 64 rows x D = 25, magnitudes over four decades) with
    the port's own stream, dequantised and averaged. The rounding's variance
    is ``s^2 p (1 - p) / draws`` per element, ``p`` the fractional part of
    ``x / s``. Returns the z of the grand mean (every element's deviation
    summed, over the summed standard error) and the largest z of one row's
    summed deviation. (One element's z is no test: at p ~ 1e-5 a single
    round-up in 256 draws is z ~ 20.)"""
    k, r, d = 16, 64, 25
    ids = torch.arange(r, dtype=torch.int32, device=DEV).repeat(k, 1)
    rows = normal(rng, (k, r, d), torch.float32) * torch.from_numpy(
        10.0 ** rng.uniform(-3, 1, (k, r, 1)).astype(np.float32)).to(DEV)
    rs = RowSparse(ids, rows, r)
    total = torch.zeros_like(rows)
    for i in range(draws):
        total += compress.dequantize_rows(compress.quantize_rows_int8(rs, (SEED, i, 0))).rows
    mean = total / draws
    scales = rows.abs().amax(-1, keepdim=True) / 127.0
    frac = rows / scales - torch.floor(rows / scales)
    se = scales * torch.sqrt(frac * (1 - frac) / draws)
    dev, var = mean - rows, se * se
    grand = float(dev.sum() / torch.sqrt(var.sum()))
    return grand, float((dev.sum(-1).abs() / torch.sqrt(var.sum(-1))).max())


def phase_int8(ds, f32_runs: dict, rng) -> tuple:
    """[24]: each run driven as in [4], K1 counted per run (20 of 20). The
    uplink bytes per round (``comm_summary``) beside the f32 plan's of the
    same local step and top-k ([4], [23]); one int8 round's profile, as
    [7]."""
    runs, launches = {}, {}
    for label, kw in INT8_RUNS:
        union_segsum.launches = 0
        runs[label] = drive(make_trainer(ds, "fedsubavg", DEV, sparse_int8=True, **kw), label)
        launches[label] = union_segsum.launches
        check(launches[label] == 20, f"{label}: K1 served {launches[label]}/20 rounds")
        f32 = f32_runs[label.replace("int8", "f32")]["comm"]
        mine = runs[label]["comm"]
        print(f"  {label}: uplink {mine['bytes_up_sparse'] / mine['rounds'] / 1e3:.1f} kB "
              f"per round against f32's {f32['bytes_up_sparse'] / f32['rounds'] / 1e3:.1f} "
              f"kB (dense {mine['bytes_up_dense'] / mine['rounds'] / 1e6:.2f} MB); downlink "
              f"{mine['bytes_down_sparse'] / mine['rounds'] / 1e3:.1f} kB; AUC "
              f"{runs[label]['auc']:.5f}")
    phase_profile(ds, runs["int8"]["steady_ms_per_round"], label="fedsubavg int8",
                  sparse_int8=True)
    grand, worst = int8_unbiased(rng)
    print(f"  int8 unbiased on the card: 256 draws of 16 x 64 x 25 rows; grand-mean z "
          f"{grand:.3f}, largest row z {worst:.3f}")
    check(abs(grand) <= 4.0 and worst <= 5.0,
          f"int8 rounding biased: grand z {grand}, row z {worst}")
    return runs, launches


def lstm_inputs(ds, rng, stacked: bool, k: int = 100, pooled: int = 500) -> dict:
    """One step's batch on the card: a cohort ``(K, I, B, ...)`` of ``k``
    clients, or a pooled ``(B, ...)`` batch of ``pooled`` samples, with the
    heat as ``heat_vocab``."""
    if stacked:
        ids = rng.choice(ds.num_clients, size=k, replace=False)
        batch = sample_cohort_batch(ds, ids, 5, 5, rng)
    else:
        batch = {key: v[0] for key, v in pooled_batches(ds, 1, pooled, rng).items()}
    out = {key: torch.from_numpy(np.ascontiguousarray(v)).to(DEV) for key, v in batch.items()}
    out["heat_vocab"] = torch.as_tensor(ds.heat.counts, dtype=torch.float32, device=DEV)
    return out


#: int8 rows on the paper's protocol: at D = 25 the rounding changes values,
#: so K1 aggregates rows that went through int8 and back
INT8_SUBMODEL = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(int8=True),
                          ServerUpdate("fedsubavg"))

#: [25]: make_round_step's modes on the LSTM; K1 launches expected per step
ROUND_STEP_MODES = (("fedsgd", "fedsgd", {}, False, 0),
                    ("fedsgd 4 microbatches", "fedsgd", dict(microbatches=4), False, 0),
                    ("sparse", "sparse", {}, False, 0),
                    ("replicated", "replicated", {}, True, 0),
                    ("sparse_replicated", "sparse_replicated", {}, True, 1),
                    ("int8 FedSgdLocal", RoundPlan(FedSgdLocal(),
                                                   RowSparseTransport(int8=True),
                                                   ServerUpdate("fedsubavg")), {}, False, 0),
                    ("int8 sparse_replicated", INT8_SUBMODEL, {}, True, 1))


def phase_round_steps(ds) -> dict:
    """[25]: 3 steps of each mode from the same initial parameters (the
    sparse modes update their table in place, so each mode takes a copy);
    loss finite, K1 counted per step, held to its plain version on the
    int8 plan's last step, then a fourth step profiled (device ops and
    device time, the busy share against the median host time of the
    three). Then ``debug_checks``
    on and off in ``sparse`` mode (no K1: its atomics' order would differ
    between any two runs), a planted unsorted ``sub_ids``, and gather before
    backward at V = 2^22."""
    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params0, axes = make_params(DEV)
    base = dict(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                local_batch=5, lr=0.5, seed=SEED)
    out = {"launches": {}}
    for label, mode, kw, stacked, want in ROUND_STEP_MODES:
        rng = np.random.default_rng(SEED + 5)
        step = make_round_step(loss_fn, params0, axes, FedConfig(**base, **kw), mode=mode)
        params = {k: v.clone() for k, v in params0.items()}
        losses, ms, per_step, captured = [], [], [], {}
        ctx = capture_k1(captured) if mode is INT8_SUBMODEL else contextlib.nullcontext()
        with ctx:
            for _ in range(3):
                batch = lstm_inputs(ds, rng, stacked)
                torch.cuda.synchronize()
                union_segsum.launches = 0
                t0 = time.perf_counter()
                params, metrics = step(params, batch)
                losses.append(float(metrics["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(union_segsum.launches)
        launches = sum(per_step)
        out["launches"][label] = launches
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
        check(per_step == [want] * 3, f"{label}: K1 launched {per_step} times in the 3 "
              f"steps, want {want} each")
        if captured:
            args, scale = captured["args"], captured["kw"]["scale"]
            ids, rows, v = args[0], args[1], args[5]
            union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
            err = check_k1(f"union_segsum[{label} step]", args, scale, union)
            out["k1_err"] = err
            print(f"  K1 at an {label} step: V={v} T={ids.numel()} D={rows.shape[-1]} "
                  f"cap={args[4]} union={union} max_abs_err={err:.3g}")
        extra = (f", sub_rows {int(metrics['sub_rows'])}, density "
                 f"{float(metrics['density']):.5f}" if "sub_rows" in metrics else "")
        batch = lstm_inputs(ds, rng, stacked)
        _, by_name, ops = device_profile(lambda: step(params, batch))
        dev_ms = sum(by_name.values()) / 1e3
        print(f"  {label}: losses {[round(x, 5) for x in losses]}, ms per step "
              f"{[round(x, 1) for x in ms]}, K1 {launches}{extra}; one step profiled: "
              f"{ops} device ops, {dev_ms:.3f} ms of device work "
              f"({dev_ms / statistics.median(ms) * 100:.1f}% busy)")

    cfg = FedConfig(**base)
    plain_plan = resolve_plan("sparse", cfg)
    results = []
    # deterministic kernels for the embedding's gradient (an accumulating
    # scatter), so that two runs may be held to each other bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plan in (plain_plan, dataclasses.replace(plain_plan, debug_checks=True)):
            rng = np.random.default_rng(SEED + 6)
            step = make_round_step(loss_fn, params0, axes, cfg, mode=plan)
            params = {k: v.clone() for k, v in params0.items()}
            losses = []
            for _ in range(3):
                params, metrics = step(params, lstm_inputs(ds, rng, False))
                losses.append(float(metrics["loss"]))
            results.append((losses, params))
    finally:
        torch.use_deterministic_algorithms(False)
    (l1, p1), (l2, p2) = results
    same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    print(f"  debug_checks on and off, sparse mode, 3 steps: equal bit for bit: {same}")
    check(same, "debug_checks changed the sparse step's losses or parameters")
    step = build_round_step(dataclasses.replace(plain_plan, debug_checks=True), loss_fn,
                            axes, params0, cfg)
    bad = torch.full((64,), -1, dtype=torch.int32, device=DEV)
    bad[:2] = torch.tensor([9, 3])
    try:
        step(ServerState({k: v.clone() for k, v in params0.items()}, (), 0),
             lstm_inputs(ds, np.random.default_rng(0), False), bad)
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"  planted unsorted sub_ids: {raised}")
    check(raised is not None and "ascending" in raised, "unsorted sub_ids did not raise")

    # gather before backward: the LSTM's table widened to the heavy shape's V
    v_heavy, d = SHAPES["heavy"][0], params0["embedding"].shape[1]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    wide = {k: v.clone() for k, v in params0.items()}
    wide["embedding"] = torch.zeros((v_heavy, d), device=DEV)
    wide["embedding"][:ds.num_features] = params0["embedding"]
    param_bytes = sum(p.numel() * p.element_size() for p in wide.values())
    table_bytes = v_heavy * d * 4
    batch = lstm_inputs(ds, np.random.default_rng(SEED + 7), False)
    batch["heat_vocab"] = torch.cat([batch["heat_vocab"], torch.zeros(
        v_heavy - ds.num_features, device=DEV)])
    step = make_round_step(loss_fn, wide, axes, cfg, mode="sparse")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wide, metrics = step(wide, batch)
    loss = float(metrics["loss"])
    heavy_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base_bytes
    print(f"  gather before backward at V = {v_heavy}, D = {d}: peak {peak / 2**20:.1f} MiB "
          f"above the earlier phases' tensors, against the parameters "
          f"{param_bytes / 2**20:.1f} MiB + one (V, D) f32 table {table_bytes / 2**20:.1f} "
          f"MiB; loss {loss:.5f}, {heavy_ms:.1f} ms, sub_rows {int(metrics['sub_rows'])}")
    check(math.isfinite(loss) and peak < param_bytes + table_bytes,
          f"gather before backward: peak {peak} bytes >= {param_bytes + table_bytes}")
    out["heavy"] = {"peak_bytes": peak, "param_bytes": param_bytes,
                    "table_bytes": table_bytes, "ms": heavy_ms}
    return out


def to_device(x, device):
    """``x`` with every tensor, RowSparse leaf included, on ``device``."""
    if isinstance(x, RowSparse):
        return RowSparse(x.ids.to(device), x.rows.to(device), x.num_rows)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x.to(device) if torch.is_tensor(x) else x


@contextlib.contextmanager
def capture_int8_stage(captured: dict):
    """Record the arguments of the round plan's compression and cohort
    aggregation, step by step, in ``captured``; the calls run."""
    real_compress, real_aggregate = (plan_mod.compress_delta_tree,
                                     plan_mod.sparse_cohort_aggregate)

    def compress_(*args, **kw):
        captured.setdefault("compress", []).append((args, kw))
        return real_compress(*args, **kw)

    def aggregate_(*args, **kw):
        captured.setdefault("aggregate", []).append((args, kw))
        return real_aggregate(*args, **kw)

    plan_mod.compress_delta_tree, plan_mod.sparse_cohort_aggregate = compress_, aggregate_
    try:
        yield
    finally:
        plan_mod.compress_delta_tree = real_compress
        plan_mod.sparse_cohort_aggregate = real_aggregate


def int8_stage_card_vs_host(captured: dict) -> float:
    """Each step's int8 rounding and cohort aggregation, on the card (K1)
    and on the host (the plain union), from the host step's client deltas
    and the host's noise: union ids exact, every aggregated leaf within
    1e-5. Returns the largest difference."""
    diff = 0.0
    for step_args in zip(captured["compress"], captured["aggregate"]):
        out = []
        for device in (DEV, torch.device("cpu")):
            (cargs, ckw), (aargs, akw) = to_device(step_args, device)
            out.append(aggregate_mod.sparse_cohort_aggregate(
                compress.compress_delta_tree(*cargs, **ckw), *aargs[1:], **akw))
        card, host = out
        for name, h in host.items():
            c = card[name]
            if isinstance(h, RowSparse):
                check(torch.equal(c.ids.cpu(), h.ids),
                      f"int8 stage '{name}': union ids differ")
                c, h = c.rows, h.rows
            diff = max(diff, float((c.cpu() - h).abs().max()))
            check(torch.allclose(c.cpu(), h, rtol=1e-5, atol=1e-5),
                  f"int8 stage '{name}': card and host differ by {diff}")
    return diff


def phase_new_card_vs_host(lr_small, lstm_small) -> None:
    """[26]: the replicated plan and int8 rows through the trainer (the
    noise drawn by the port's own stream on the host and copied to the
    card, so both see the same uniforms), then make_round_step fedsgd and
    sparse and the int8 submodel plan on the LSTM (D = 25, where the
    rounding changes values and K1 sums them; the noise from the host as
    above; its table held step by step, see the module's docstring), 3
    steps card against host, then Example 1. No case
    has a binding top-k: LR's tied rows would be broken by last-ulp sums
    differently on each side (ROADMAP Queue 3)."""
    phase_card_vs_host(lr_small, rounds=3, cases=(
        ("fedsubavg replicated", "fedsubavg", dict(sparse_local="replicated")),))
    host_uniform = compress.int8_uniform
    compress.int8_uniform = (lambda shape, seed, rounds, leaf, device:
                             host_uniform(shape, seed, rounds, leaf, "cpu").to(device))
    try:
        phase_card_vs_host(lr_small, rounds=3, cases=(
            ("fedsubavg int8", "fedsubavg", dict(sparse_int8=True)),
            ("fedsubavg int8 replicated", "fedsubavg",
             dict(sparse_int8=True, sparse_local="replicated"))))
    finally:
        compress.int8_uniform = host_uniform

    make_params, loss_fn, _ = task_bindings(lstm_small, SEED)
    cfg = FedConfig(num_clients=lstm_small.num_clients, clients_per_round=100,
                    local_iters=5, local_batch=5, lr=0.5, seed=SEED)
    for label, mode, stacked in (("fedsgd", "fedsgd", False), ("sparse", "sparse", False),
                                 ("int8 sparse_replicated", INT8_SUBMODEL, True)):
        runs, captured = [], {}
        compress.int8_uniform = (lambda shape, seed, rounds, leaf, device:
                                 host_uniform(shape, seed, rounds, leaf, "cpu").to(device))
        try:
            for device in (DEV, torch.device("cpu")):
                params, axes = make_params(device)
                step = make_round_step(loss_fn, params, axes, cfg, mode=mode)
                rng, losses = np.random.default_rng(SEED + 8), []
                ctx = (capture_int8_stage(captured) if device.type == "cpu"
                       else contextlib.nullcontext())
                with ctx:
                    for _ in range(3):
                        batch = {k: v.to(device)
                                 for k, v in lstm_inputs(lstm_small, rng, stacked).items()}
                        params, metrics = step(params, batch)
                        losses.append(float(metrics["loss"]))
                runs.append((losses, params))
            stage = int8_stage_card_vs_host(captured) if "compress" in captured else None
        finally:
            compress.int8_uniform = host_uniform
        (lc, pc), (lh, ph) = runs
        dl = max(abs(a - b) for a, b in zip(lc, lh))
        diffs = {k: (pc[k].cpu() - ph[k]).abs() for k in pc}
        print(f"  lstm make_round_step {label}: 3 steps card vs host: max |loss diff| "
              f"{dl:.3g}, max |param diff| by leaf "
              + ", ".join(f"{k} {float(d.max()):.3g}" for k, d in diffs.items()))
        # int8 tables are held stage by stage: the card's and the host's
        # local deltas differ in the last ulp, and a ulp near a rounding
        # boundary moves floor(x / s + u) by one quantum, s = max|row| / 127
        held = {k for k in pc if not (mode is INT8_SUBMODEL and axes[k][:1] == ("vocab",))}
        if stage is not None:
            table = [(k, int((d > 1e-5).sum()), d.numel()) for k, d in diffs.items()
                     if k not in held]
            print(f"    int8 rounding and K1 of each step, card against host from the "
                  f"host's deltas: max |diff| {stage:.3g}; table elements off by more "
                  f"than 1e-5 after 3 steps (the rounding's flips): {table}")
        check(dl <= 1e-5 and all(torch.allclose(pc[k].cpu(), ph[k], rtol=1e-5, atol=1e-5)
                                 for k in held), f"lstm {label}: card and host differ")

    n = 100                      # examples/example1_illconditioning.py
    counts = np.array([1.0, float(n)])
    kappas = []
    for device in (DEV, torch.device("cpu")):
        h = torch.diag(torch.tensor([2.0 / n, 2.0], device=device))
        kappas.append((condition_number(h),
                       condition_number(preconditioned_hessian(h, counts, float(n)))))
    (kc, kc_hat), (kh, kh_hat) = kappas
    print(f"  Example 1: kappa(H) card {kc:.6f} host {kh:.6f}; kappa(D^1/2 H D^1/2) card "
          f"{kc_hat:.6f} host {kh_hat:.6f}")
    check(abs(kc - kh) <= 1e-5 * kh and abs(kc_hat - kh_hat) <= 1e-5 * kh_hat
          and abs(kc - n) <= 1e-3 * n, "Example 1's condition numbers differ")


# ---------------------------------------------------------------------------
# Round telemetry, the trace sink, profile_dir and the buffered-async engine
# ---------------------------------------------------------------------------

#: git-ignored; traces, sinks and checkpoints of [27]-[30]
OUT_DIR = ROOT / "build" / "chip_smoke"
#: RoundTelemetry fields compared exactly between card and host
TEL_EXACT = ("dropped_ids", "dropped_per_client", "union_size", "agg_rows",
             "heat_hist", "staleness_hist", "buffer_occupancy", "round", "event")


def params_diff(a: dict, b: dict) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def params_close(a: dict, b: dict, tol: float) -> bool:
    """Every leaf within ``tol`` (``torch.allclose``, rtol = atol = tol)."""
    return all(torch.allclose(a[k].cpu(), b[k].cpu(), rtol=tol, atol=tol) for k in a)


def telemetry_diff(card: list, host: list) -> float:
    """Round events of two runs: integer fields equal; returns the largest
    difference of the float fields (``None`` fields must agree)."""
    check(len(card) == len(host), f"{len(card)} against {len(host)} telemetry events")
    worst = 0.0
    for c, h in zip(card, host):
        check(set(c) == set(h), "telemetry keys differ")
        for name, w in h.items():
            g = c[name]
            if name in TEL_EXACT or name == "comm" or w is None:
                check(g == w, f"telemetry {name}: card {g} host {w}")
            else:
                worst = max(worst, float(np.abs(np.asarray(g) - np.asarray(w)).max()))
    return worst


def ops_per_round(tr: FederatedTrainer, n: int = 3) -> tuple:
    """Device ops and device ms per round over ``n`` warm ``run_round``
    calls (torch.profiler through ``device_profile``)."""
    _, by_name, ops = device_profile(lambda: [tr.run_round() for _ in range(n)])
    return ops / n, sum(by_name.values()) / n / 1e3


def stretch_firsts(tr: FederatedTrainer) -> list:
    """Wrap the trainer's dispatch marker: the returned list gains, per
    dispatch, the round count before it and whether it was a first."""
    seen, mark = [], tr._mark_dispatch

    def marked(key):
        before = tr._rounds_run
        mark(key)
        seen.append((before, tr._last_dispatch_first))

    tr._mark_dispatch = marked
    return seen


def phase_telemetry(ds, lstm_ds) -> dict:
    """[27]: fedsubavg at [4]'s configuration, 20 rounds through ``run``
    and 20 through ``run(engine=True)``, each with telemetry on (a JSONL
    sink), off, and off again (the control); K1 20 of 20 per run; on
    against off: records within 1e-6, parameters within 1e-5 (K1's atomic
    order differs between any two runs, the control's too); every round's heat
    histogram sums to its union size, no drop at the pow2 capacity; the
    sink reads back; first dispatches booked exactly in the stretches that
    had one. Then ms and device ops per round on and off, the LSTM's sparse
    ``FedSgdLocal`` step (no K1) on and off bit for bit under deterministic
    algorithms, and a planted capacity of 16 against a numpy count."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out, trainers = {"launches": {}}, {}
    for engine in (False, True):
        for tel in (True, False, None):
            # None: a second run with telemetry off, the control for K1's order
            label = (f"run{'(engine=True)' if engine else ''} telemetry "
                     f"{'on' if tel else 'off'}{' again' if tel is None else ''}")
            path = OUT_DIR / f"sink_engine{int(engine)}.jsonl"
            tr = make_trainer(ds, "fedsubavg", DEV, telemetry=bool(tel),
                              sink=TraceSink(str(path)) if tel else None)
            firsts = stretch_firsts(tr)
            union_segsum.launches = 0
            tr.run(20, eval_every=10, engine=engine)
            launches = union_segsum.launches
            out["launches"][label] = launches
            check(launches == 20, f"{label}: K1 served {launches}/20 rounds")
            # run_round counts the round before its dispatch, run_rounds after
            per_stretch = [any(f for r, f in firsts if (r - (not engine)) // 10 == i)
                           for i in range(2)]
            booked = [h.compile_time > 0 for h in tr.history]
            check(booked == per_stretch and booked[0],
                  f"{label}: compile_time {[h.compile_time for h in tr.history]} against "
                  f"first dispatches by stretch {per_stretch}")
            trainers[(engine, tel)] = tr
            if tel:
                tr.sink.close()
                events = read_events(str(path))
                rounds = [e for e in events if e["event"] == "round"]
                check({e["event"] for e in events} == {"round", "record"}
                      and len(rounds) == 20 and len(events) == 22, f"{label}: sink events")
                check(all(sum(e["heat_hist"]) == e["union_size"] > 0 for e in rounds),
                      f"{label}: a heat histogram does not sum to its union")
                check(all(e["dropped_ids"] == 0 and e["dropped_mass"] == 0.0 for e in rounds),
                      f"{label}: ids dropped at the pow2 capacity")
                check(tr.telemetry_log == rounds, f"{label}: sink and telemetry_log differ")
            print(f"  {label}: K1 {launches}/20; records' steady ms/round "
                  f"{[round(h.wall_time * 1e3, 2) for h in tr.history]}, first-dispatch s "
                  f"{[round(h.compile_time, 4) for h in tr.history]}")
        on, off, again = (trainers[(engine, t)] for t in (True, False, None))
        dl = max(max(abs(a.train_loss - b.train_loss), abs(a.test_metric - b.test_metric))
                 for a, b in zip(on.history, off.history))
        dp = params_diff(on.state.params, off.state.params)
        dc = params_diff(again.state.params, off.state.params)
        print(f"  on against off ({'engine' if engine else 'loop'}): max |train loss or AUC "
              f"diff| {dl:.3g}, max |param diff| {dp:.3g} (off against off: {dc:.3g}, K1's "
              f"atomic order on rows scaled by up to N / n_m = {ds.num_clients}); union "
              f"size mean {on.telemetry_summary()['mean_union_size']:.1f}")
        # the parameters as card against host ([5]): 1e-6 does not hold between
        # any two runs of K1 here, telemetry or not
        check(dl <= 1e-6 and params_close(on.state.params, off.state.params, 1e-5),
              f"telemetry on and off differ: {dl}, {dp}")
    for tel in (True, False):
        tr = trainers[(False, tel)]
        ms = statistics.mean(h.wall_time for h in tr.history) * 1e3
        ops, dev_ms = ops_per_round(tr)
        out["on" if tel else "off"] = {"ms_per_round": ms, "device_ops_per_round": ops,
                                       "device_ms_per_round": dev_ms}
        print(f"  telemetry {'on' if tel else 'off'}: {ms:.2f} ms/round steady (run), "
              f"{ops:.0f} device ops and {dev_ms:.3f} ms of device work per round")

    make_params, loss_fn, _ = task_bindings(lstm_ds, SEED)
    params0, axes = make_params(DEV)
    cfg = FedConfig(num_clients=lstm_ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    results = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tel in (False, True):
            rng = np.random.default_rng(SEED + 6)
            step = make_round_step(loss_fn, params0, axes, cfg, mode="sparse", telemetry=tel)
            params, losses, tels = {k: v.clone() for k, v in params0.items()}, [], []
            for _ in range(3):
                params, m = step(params, lstm_inputs(lstm_ds, rng, False))
                losses.append(float(m["loss"]))
                tels.append(m.get("telemetry"))
            results.append((losses, params, tels))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, p0, _), (l1, p1, tels) = results
    same = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    host = [telemetry_to_host(t) for t in tels]
    print(f"  LSTM sparse FedSgdLocal, 3 steps, telemetry on and off: equal bit for bit: "
          f"{same}; union sizes {[h['union_size'] for h in host]}, delta norms "
          f"{[round(h['delta_norm_pre'], 5) for h in host]}")
    check(same, "telemetry changed the sparse FedSgdLocal step")
    check(all(sum(h["heat_hist"]) == h["union_size"] > 0 for h in host), "LSTM heat hist")

    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params, axes = make_params(DEV)
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    step = build_round_step(resolve_plan("sparse_replicated", cfg, feature_key="features"),
                            loss_fn, axes, params, cfg, telemetry=True)
    rng = np.random.default_rng(SEED + 9)
    batch = sample_cohort_batch(ds, rng.choice(ds.num_clients, 100, replace=False), 5, 5, rng)
    feats = batch["features"].reshape(100, -1)
    valid = np.where((feats >= 0) & (feats < ds.num_features), feats, -1)
    cap = 16
    small = unique_ids_padded(torch.from_numpy(valid).to(DEV), cap)
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEV) for k, v in batch.items()}
    dev_batch["heat_vocab"] = torch.as_tensor(ds.heat.counts, dtype=torch.float32, device=DEV)
    _, m = step(ServerState(params, (), 0), dev_batch, small)
    tel = telemetry_to_host(m["telemetry"])
    dropped, mass = [], 0
    for row in valid:
        kept = np.unique(row[row >= 0])[:cap]
        dropped.append(len(np.unique(row[row >= 0])) - kept.size)
        mass += int(((row >= 0) & ~np.isin(row, kept)).sum())
    print(f"  planted capacity {cap}, K = 100: dropped ids {tel['dropped_ids']} (numpy "
          f"{sum(dropped)}), mass {tel['dropped_mass']:.0f} (numpy {mass}), union "
          f"{tel['union_size']}")
    check(tel["dropped_per_client"] == dropped and tel["dropped_ids"] == sum(dropped) > 0
          and tel["dropped_mass"] == float(mass), "planted capacity: drop counts differ")
    return out


def phase_profile_dir(ds) -> dict:
    """[28]: ``run(2, profile_dir=...)`` writes one trace holding its
    ``rounds[a:b]`` range and K1's events, as many as K1's launch counter
    rose by (the rule of ``device_profile``: a trace short of them is the
    profiler's miss, taken again)."""
    tr = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    tr.run_round()
    for attempt in range(5):
        pdir = OUT_DIR / f"profile_{attempt}"
        shutil.rmtree(pdir, ignore_errors=True)
        torch.cuda.synchronize()
        before = union_segsum.launches
        a = tr._rounds_run
        tr.run(2, eval_every=2, profile_dir=str(pdir))
        rise = union_segsum.launches - before
        files = sorted(pdir.glob("*.pt.trace.json"))
        check(len(files) == 1, f"profile_dir holds {files}")
        events = json.loads(files[0].read_text())["traceEvents"]
        ranges = sorted({e["name"] for e in events
                         if re.fullmatch(r"rounds\[\d+:\d+\]", str(e.get("name", "")))})
        k1 = sum(1 for e in events if e.get("cat") == "kernel"
                 and "union_segsum_kernel" in str(e.get("name", "")))
        if k1 == rise:
            break
        print(f"    (the trace holds {k1} K1 events against {rise} launches: profiling again)")
    print(f"  {files[0].name}: {files[0].stat().st_size / 1e6:.2f} MB, {len(events)} events, "
          f"ranges {ranges}, K1 events {k1} = launches {rise}")
    check(k1 == rise == 2 and ranges == [f"rounds[{a}:{a + 2}]"],
          f"profile_dir: ranges {ranges}, K1 {k1} against {rise}")
    return {"k1_events": k1, "ranges": ranges}


def ops_by_range(prof, names) -> dict:
    """``{name: [ranges, device ops, device us, host us]}`` for each named
    host range of a profile: a device event belongs to the range its launch
    call (matched by correlation id) falls in."""
    path = OUT_DIR / "ranges.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == n and e.get("cat") == "user_annotation"] for n in names}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {n: [len(s), 0, 0.0, sum(b - a for a, b in s)] for n, s in spans.items()}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        for n, s in spans.items():
            if t is not None and any(a <= t <= b for a, b in s):
                out[n][1] += 1
                out[n][2] += e["dur"]
    return out


ASYNC_SIM = dict(num_rounds=20, delay="lognormal", delay_scale=0.5, lognormal_sigma=1.2,
                 straggler_frac=0.05, dropout_frac=0.02, seed=8)


def phase_async(ds, sync_ms: float) -> dict:
    """[29]: (a) zero delay, ``buffer_size = K``: ``run_async`` over 10
    waves against ``run_rounds(10)`` within 1e-5, the next numpy draw
    equal, K1 10 of 10 fires; (b) ``ASYNC_SIM`` with 25-arrival buffers,
    polynomial staleness and EMA heat: K1 once per fire, each fire's
    staleness histogram sums to 25, loss falls and AUC > 0.5, the rows only
    dropped-out clients touch unchanged; its time per event and per fire, a
    profiled rerun's device ops per dispatch and per fire, K1 at the fire's
    shape; (c) the same schedule with 100-arrival buffers and constant
    weights."""
    from torch.autograd import DeviceType

    out = {"launches": {}}
    sync = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    asyn = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    ls = sync.run_rounds(10)
    union_segsum.launches = 0
    la = asyn.run_async(ArrivalSim(num_rounds=10))
    launches = union_segsum.launches
    out["launches"]["zero delay"] = launches
    dl = max(abs(a - b) for a, b in zip(ls, la))
    dp = params_diff(sync.state.params, asyn.state.params)
    same_draw = sync.np_rng.integers(1 << 30) == asyn.np_rng.integers(1 << 30)
    print(f"  (a) zero delay, M = K = 100, 10 waves: K1 {launches}/10 fires; against "
          f"run_rounds(10): max |loss diff| {dl:.3g}, max |param diff| {dp:.3g}; next "
          f"draw equal: {same_draw}")
    check(launches == 10 and dl <= 1e-5 and same_draw and len(la) == 10
          and params_close(sync.state.params, asyn.state.params, 1e-5),
          "zero-delay async differs from run_rounds")

    for tag, srv in (("b", BufferedAsyncServerUpdate(buffer_size=25, staleness="polynomial",
                                                     heat="ema")),
                     ("c", BufferedAsyncServerUpdate(buffer_size=100, heat="ema"))):
        sim = ArrivalSim(**ASYNC_SIM)
        sch = sim.compile(100, srv.buffer_size)
        tr = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
        waves, sample = [], tr._sample_sparse_cohort

        def recorded():
            c, f = sample()
            waves.append(f)
            return c, f

        tr._sample_sparse_cohort = recorded
        loss0, table0 = tr.train_loss(), tr.state.params["w"].clone()
        captured = {}
        union_segsum.launches = 0
        torch.cuda.synchronize()
        with capture_k1(captured):
            t0 = time.perf_counter()
            losses = tr.run_async(sim, server=srv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = union_segsum.launches
        out["launches"][tag] = launches
        fires = tr.telemetry_log[-sch.num_fires:]
        loss1, auc = tr.train_loss(), tr.evaluate()
        feats = np.concatenate(waves)

        def touched(mask):
            ids = feats[mask].ravel()
            return np.unique(ids[(ids >= 0) & (ids < ds.num_features)])

        private = np.setdiff1d(touched(sch.dropped), touched(~sch.dropped))
        at = torch.from_numpy(private).to(DEV)
        untouched = torch.equal(tr.state.params["w"][at], table0[at])
        moved = int((tr.state.params["w"] != table0).any(-1).sum())
        res = {"events": sch.num_events, "fires": sch.num_fires, "wall_s": wall,
               "ms_per_event": wall / sch.num_events * 1e3,
               "ms_per_fire": wall / sch.num_fires * 1e3, "launches": launches}
        out[tag] = res
        print(f"  ({tag}) M = {srv.buffer_size}, {srv.staleness} staleness, EMA heat: "
              f"{sch.num_tasks} tasks, {int(sch.dropped.sum())} dropped, {sch.num_events} "
              f"events, {sch.num_slots} slots, {sch.num_fires} fires (simulated speedup over "
              f"the barrier {sch.sim_speedup():.2f}); K1 {launches}; {wall:.2f} s: "
              f"{res['ms_per_event']:.3f} ms/event, {res['ms_per_fire']:.2f} ms/fire "
              f"(a synchronous round {sync_ms:.2f} ms)")
        print(f"    loss {loss0:.5f} -> {loss1:.5f}, AUC {auc:.5f}; fire losses "
              f"{[round(x, 4) for x in losses[:3]]} ... {[round(x, 4) for x in losses[-3:]]}; "
              f"staleness of the last fire {fires[-1]['staleness_hist']}; "
              f"{private.size} rows only dropped clients touch, unchanged: {untouched} "
              f"({moved} rows moved)")
        check(launches == sch.num_fires == len(losses), f"({tag}) K1 {launches} against "
              f"{sch.num_fires} fires")
        check(all(sum(e["staleness_hist"]) == srv.buffer_size for e in fires),
              f"({tag}) a fire's staleness histogram")
        check(all(math.isfinite(x) for x in losses) and loss1 < loss0 and auc > 0.5,
              f"({tag}) loss {loss0} -> {loss1}, AUC {auc}")
        check(private.size > 0 and untouched, f"({tag}) dropped clients' rows")
        if tag == "b":
            args, scale = captured["args"], captured["kw"]["scale"]
            ids, rows, v = args[0], args[1], args[5]
            union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
            err = check_k1("union_segsum[async fire]", args, scale, union)
            again = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
            prof, by_name, ops = device_profile(lambda: again.run_async(sim, server=srv))
            # K1's device ops and time per call from the run's own profile: a
            # short profile of a few K1 calls after [28]'s has come back empty
            # five times in a row
            k1_us = [us for name, us in by_name.items() if "union_segsum_kernel" in name]
            k1_ops = sum(1 for e in prof.events() if "union_segsum_kernel" in e.name
                         and e.device_type == DeviceType.CUDA)
            timed = time_k1_k2(args, scale, "async fire", keys=("k1",), profiled={
                "k1": (k1_ops / sch.num_fires, sum(k1_us) / sch.num_fires / 1e3)})
            out["k1"] = {"shape": timed["shape"], "max_abs_err": err, **timed["k1"]}
            names = ("async_engine.dispatch", "async_engine.arrive", "async_engine.fire")
            ranges = ops_by_range(prof, names)
            n_dispatch = int((sch.kind == 0).sum())
            d, a, f = (ranges[n] for n in names)
            res.update(device_ops=ops, device_ms=sum(by_name.values()) / 1e3,
                       ops_per_dispatch=d[1] / n_dispatch,
                       ranges={n[len("async_engine."):]: {
                           "count": r[0], "device_ops_each": r[1] / max(r[0], 1),
                           "device_ms_each": r[2] / 1e3 / max(r[0], 1),
                           "host_ms_each_profiled": r[3] / 1e3 / max(r[0], 1)}
                           for n, r in ranges.items()})
            print(f"    profiled rerun: {ops} device ops, {res['device_ms']:.2f} ms of device "
                  f"work ({res['device_ms'] / (wall * 1e3) * 100:.1f}% of the unprofiled "
                  f"run's wall time); {res['ops_per_dispatch']:.2f} device ops per dispatch")
            for n, r in res["ranges"].items():
                print(f"      {r['count']} {n} ranges: {r['device_ops_each']:.1f} device ops, "
                      f"{r['device_ms_each']:.4f} ms of device work and "
                      f"{r['host_ms_each_profiled']:.3f} ms of host time (profiled) each")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            for name, us in top:
                print(f"      {us / 1e3:.3f} ms  {name[:100]}")
            check(f[0] == sch.num_fires and d[1] + a[1] + f[1] <= ops,
                  f"ranges {ranges} against {ops} device ops")
    return out


def phase_async_card_vs_host(small) -> None:
    """[30]: ``ASYNC_SIM`` over 6 waves of K = 20 on 200 clients, (b)'s
    server slot, telemetry on and a top-k above every client's submodel, on
    the card and on ``device="cpu"``: losses, parameters and the EMA heat
    within 1e-5, telemetry's integer fields equal and its floats within
    1e-5. Then a mid-run checkpoint: the first half of the events on the
    card, ``save_checkpoint``, ``load_checkpoint`` on the host into a fresh
    ``AsyncState``, the second half there; it equals the uninterrupted host
    run within 1e-5."""
    sim = ArrivalSim(**{**ASYNC_SIM, "num_rounds": 6})
    srv = BufferedAsyncServerUpdate(buffer_size=25, staleness="polynomial", heat="ema")
    kw = dict(clients_per_round=20, sparse_topk=1 << 16)
    runs = []
    for device in (DEV, torch.device("cpu")):
        tr = make_trainer(small, "fedsubavg", device, telemetry=True, **kw)
        runs.append((tr, tr.run_async(sim, server=srv)))
    (card, lc), (host, lh) = runs
    dl = max(abs(a - b) for a, b in zip(lc, lh))
    dp = params_diff(card.state.params, host.state.params)
    dh = float((card._async_heat_ema.cpu() - host._async_heat_ema).abs().max())
    dt = telemetry_diff(card.telemetry_log, host.telemetry_log)
    print(f"  {len(lc)} fires card vs host: max |loss diff| {dl:.3g}, |param diff| {dp:.3g}, "
          f"|heat EMA diff| {dh:.3g}, telemetry integers equal, floats within {dt:.3g}")
    check(len(lc) == len(lh) > 0 and max(dl, dh, dt) <= 1e-5
          and params_close(card.state.params, host.state.params, 1e-5),
          f"async card and host differ: {dl}, {dp}, {dh}, {dt}")

    mid = str(OUT_DIR / "async_mid")
    part = make_trainer(small, "fedsubavg", DEV, telemetry=True, **kw).prepare_async(sim, srv)
    sch = part.schedule
    cut = sch.num_events // 2
    half, _ = part.engine.run(part.state, sch.slice_events(0, cut), part.tasks,
                              part.sub_ids, part.feats)
    save_checkpoint(mid, half, step=cut)
    rest = make_trainer(small, "fedsubavg", "cpu", telemetry=True, **kw).prepare_async(sim, srv)
    resumed = load_checkpoint(mid, rest.state)
    done, _ = rest.engine.run(resumed, sch.slice_events(cut, sch.num_events), rest.tasks,
                              rest.sub_ids, rest.feats)
    dp = params_diff(done.server.params, host.state.params)
    dh = float((done.heat_ema - host._async_heat_ema).abs().max())
    print(f"  mid-run checkpoint after {cut} of {sch.num_events} events ({half.arrivals} "
          f"arrivals, {half.server.rounds} fires, {half.buf_count} buffered) on the card, "
          f"resumed on the host: max |param diff| {dp:.3g}, |heat EMA diff| {dh:.3g} "
          f"against the uninterrupted host run")
    check(done.server.rounds == len(lh) and dh <= 1e-5
          and params_close(done.server.params, host.state.params, 1e-5),
          f"checkpoint resume differs: {dp}, {dh}")


# ---------------------------------------------------------------------------
# Cohort-sharded rounds over torch.distributed ([31]-[33])
# ---------------------------------------------------------------------------

#: the join of a spawned mesh: a rank stuck in a collective fails the run
MESH_TIMEOUT_S = 300.0
#: [33]: make_round_step's modes on the mesh (label, mode, stacked, K, debug)
MESH_STEP_MODES = (("fedsgd", "fedsgd", False, 100, False),
                   ("sparse", "sparse", False, 100, False),
                   ("replicated", "replicated", True, 100, False),
                   ("sparse_replicated", "sparse_replicated", True, 100, False),
                   ("sparse_replicated K=3 debug_checks", "sparse_replicated", True, 3, True))


def cpu_tree(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def mesh_drive(tr: FederatedTrainer, rounds: int) -> dict:
    """Half the rounds through ``run_round`` (timed one by one), the rest
    through ``run(engine=True)`` with the evaluation at its end; K1's
    launches counted from 0."""
    n1 = rounds // 2
    union_segsum.launches = 0
    losses, ms = [], []
    for _ in range(n1):
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        ms.append((time.perf_counter() - t0) * 1e3)
    tr.run(rounds - n1, eval_every=rounds - n1, engine=True)
    rec = tr.history[-1]
    return {"rounds": rounds, "loss": losses, "ms": ms, "train_loss": rec.train_loss,
            "auc": rec.test_metric,
            "launches": union_segsum.launches, "params": cpu_tree(tr.state.params),
            "comm": tr.comm_summary()}


def mesh_trainer_job(mesh, job: dict) -> dict:
    """A trainer on the mesh: the job's algorithm and combine, ``rounds``
    rounds by ``mesh_drive``; the last round's collective counters, and
    with ``capture`` the inputs of the last round's K1 calls."""
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                     ServerUpdate(job["alg"]),
                     sharding=CohortSharding(mesh, combine=job["combine"]))
    tr = make_trainer(job["ds"], job["alg"], mesh.device, plan=plan, mesh=mesh)
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return union_segsum(*args, **kw)

    if job.get("capture"):
        aggregate_mod.union_segsum = capture
    try:
        out = mesh_drive(tr, job["rounds"])
    finally:
        aggregate_mod.union_segsum = union_segsum
    out["counters"] = dict(mesh.counters)
    out["combine"] = {name: pick_combine(p.shape[0], p[0].numel(), job["combine"])
                      for name, p in tr.state.params.items() if name in tr._sparse_paths}
    per_round = out["launches"] // job["rounds"]
    out["k1_calls"] = [(tuple(a.cpu() if torch.is_tensor(a) else a for a in args), kw)
                       for args, kw in calls[len(calls) - per_round:]] if calls else []
    return out


def mesh_steps_job(mesh, job: dict) -> dict:
    """[33]: ``make_round_step`` on the LSTM's inputs, each mode of
    ``MESH_STEP_MODES`` 3 steps on the mesh; rank 0 also runs the unsharded
    step on the same batches. K1 and the collective counters per step, the
    counters held to ``round_collective_budget``."""
    ds = job["ds"]
    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params0, axes = make_params(mesh.device)
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    out = {}
    for label, mode, stacked, k, debug in MESH_STEP_MODES:
        plan = dataclasses.replace(resolve_plan(mode, cfg), debug_checks=debug)
        sharded = dataclasses.replace(plan, sharding=CohortSharding(mesh))
        step = make_round_step(loss_fn, params0, axes, cfg, mode=sharded)
        plain = make_round_step(loss_fn, params0, axes, cfg, mode=plan)
        ps = {n: v.clone() for n, v in params0.items()}
        pu = {n: v.clone() for n, v in params0.items()}
        rng = np.random.default_rng(SEED + 8)
        res = {"loss": [], "plain_loss": [], "launches": [], "counters_equal_budget": [],
               "ms": []}
        for _ in range(3):
            batch = lstm_inputs(ds, rng, stacked, k=k)
            budget = round_collective_budget(sharded, axes, ps, cfg, batch)
            if DEV.type == "cuda":
                torch.cuda.synchronize()
            union_segsum.launches = 0
            t0 = time.perf_counter()
            ps, m = step(ps, batch)
            res["loss"].append(float(m["loss"]))
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append(union_segsum.launches)
            res["counters_equal_budget"].append(mesh.counters == budget["components"])
            res["by_op"] = mesh.by_op()
            if mesh.rank == 0:
                pu, mu = plain(pu, batch)
                res["plain_loss"].append(float(mu["loss"]))
        res["params"] = cpu_tree(ps)
        if mesh.rank == 0:
            res["plain_params"] = cpu_tree(pu)
        out[label] = res
    return out


MESH_JOBS = {"trainer": mesh_trainer_job, "steps": mesh_steps_job}


def mesh_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
              jobs: list, device: str) -> None:
    """One rank of a cohort mesh spawned on this host: every rank on the
    parent's device (the one card); checks that the backend's all-reduce
    and all-gather take the device's tensors, runs ``jobs`` and saves its
    results for the parent."""
    global DEV
    DEV = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_cohort_mesh(device=DEV, backend=backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        x = torch.full((3,), float(rank + 1), device=mesh.device)
        s, g = mesh.psum(x, "probe"), mesh.all_gather(x.to(torch.int32), "probe:gather")
        check(s.device == mesh.device
              and torch.equal(s.cpu(), torch.full((3,), world * (world + 1) / 2)),
              f"rank {rank}: all-reduce of a {mesh.device} tensor gave {s}")
        check(torch.equal(g[:, 0].cpu(), torch.arange(1, world + 1, dtype=torch.int32)),
              f"rank {rank}: all-gather of a {mesh.device} tensor gave {g}")
        results = {job["label"]: MESH_JOBS[job["kind"]](mesh, job) for job in jobs}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
        mesh.barrier()
    finally:
        mesh.destroy()


def run_mesh(world: int, backend: str, jobs: list) -> list:
    """Spawn ``world`` ranks of ``mesh_rank`` on the card; their results by rank."""
    out_dir = Path(tempfile.mkdtemp(prefix=f"mesh{world}_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        spawn_ranks(mesh_rank, world, args=(world, backend, str(out_dir / "store"),
                                            str(out_dir), jobs, str(DEV)),
                    timeout_s=MESH_TIMEOUT_S)
        res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  {world} rank(s), {backend}: spawned, ran and joined in "
          f"{time.perf_counter() - t0:.1f} s")
    return res


def rank_spread(ranks: list, key: str) -> float:
    """Largest difference of any rank's ``params`` from rank 0's under ``key``."""
    return max(params_diff(r[key]["params"], ranks[0][key]["params"]) for r in ranks)


#: rounds of [31] (LR) and [32] (DIN) on the mesh and on one device
MESH_LR_ROUNDS, MESH_DIN_ROUNDS = 20, 10


def phase_mesh_runs(lr_ds, din_ds, lstm_ds) -> tuple:
    """[31]-[33]'s runs: the unsharded trainers on the card, then one spawn
    per world size: 1 rank on NCCL (LR), 2 ranks on gloo (LR, DIN and the
    round steps of [33]) and 4 on gloo (LR), every rank on the one card.
    Returns the unsharded runs and the ranks' results by world size."""
    plain = {f"lr {alg}": mesh_drive(make_trainer(lr_ds, alg, DEV), MESH_LR_ROUNDS)
             for alg in ("fedsubavg", "fedavg")}
    plain["din fedsubavg"] = mesh_drive(make_trainer(din_ds, "fedsubavg", DEV),
                                        MESH_DIN_ROUNDS)
    lr_jobs = [dict(kind="trainer", label=f"lr {alg} {comb}", ds=lr_ds, alg=alg,
                    combine=comb, rounds=MESH_LR_ROUNDS, capture=comb == "union")
               for alg, comb in (("fedsubavg", "auto"), ("fedavg", "auto"),
                                 ("fedsubavg", "union"))]
    more = [dict(kind="trainer", label="din fedsubavg auto", ds=din_ds, alg="fedsubavg",
                 combine="auto", rounds=MESH_DIN_ROUNDS),
            dict(kind="steps", label="steps", ds=lstm_ds)]
    ranks = {1: run_mesh(1, "nccl", lr_jobs[:2]), 2: run_mesh(2, "gloo", lr_jobs + more),
             4: run_mesh(4, "gloo", lr_jobs)}
    return plain, ranks


def check_mesh_trainer(ranks: list, label: str, want: dict) -> dict:
    """One trainer job on every rank against the unsharded run: K1 once per
    round and rank under psum, once per rank more under union (the
    partial, then one call per further rank); losses, train loss and
    parameters within 1e-5; every rank's parameters equal rank 0's."""
    world, r0 = len(ranks), ranks[0][label]
    (mode,) = r0["combine"].values()
    rounds = r0["rounds"]
    per_round = world if mode == "union" else 1
    launches = [r[label]["launches"] for r in ranks]
    check(launches == [per_round * rounds] * world,
          f"x{world} {label}: K1 launched {launches} times per rank in {rounds} rounds, "
          f"want {per_round * rounds} each")
    loss_err = max(abs(a - b) for a, b in zip(r0["loss"], want["loss"]))
    check(loss_err <= 1e-5, f"x{world} {label}: losses {loss_err} from the unsharded "
          "trainer's")
    check(abs(r0["train_loss"] - want["train_loss"]) <= 1e-5,
          f"x{world} {label}: train loss {r0['train_loss']} against {want['train_loss']}")
    params_err = params_diff(r0["params"], want["params"])
    check(params_close(r0["params"], want["params"], 1e-5),
          f"x{world} {label}: parameters {params_err} from the unsharded trainer's")
    spread = rank_spread(ranks, label)
    check(spread == 0.0, f"x{world} {label}: ranks differ by {spread}")
    ms, plain_ms = statistics.median(r0["ms"][2:]), statistics.median(want["ms"][2:])
    by_op = {}
    for c in r0["counters"].values():
        by_op[c["op"]] = by_op.get(c["op"], 0) + c["bytes"]
    print(f"  x{world} {label} ({mode}): loss err {loss_err:.3g}, params err "
          f"{params_err:.3g}, ranks equal bit for bit; K1 per rank {launches}; ms/round "
          f"(rank 0) {ms:.2f} against {plain_ms:.2f} unsharded; bytes per rank per round "
          f"by op {by_op}; AUC {r0['auc']:.5f} against {want['auc']:.5f}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms}


def phase_mesh_lr(plain: dict, ranks: dict) -> dict:
    """[31]: LR through ``FederatedTrainer(mesh=...)`` at world sizes 1
    (NCCL), 2 and 4 (gloo on the card's tensors; the ranks share the one
    card), fedsubavg and fedavg (``auto``: psum at V x 1 f32), and
    fedsubavg with ``combine="union"``, 20 rounds each, against the
    unsharded trainer on the card."""
    out = {"launches": {}, "k1_calls": []}
    for world, rks in sorted(ranks.items()):
        for label in rks[0]:
            if label.startswith("lr "):
                alg = label.split()[1]
                res = check_mesh_trainer(rks, label, plain[f"lr {alg}"])
                out["launches"][f"x{world} {label[3:]}"] = res["launches"]
        if world == 2:
            out["k1_calls"] = rks[0]["lr fedsubavg union"]["k1_calls"]
    print("  (ranks sharing one card measure the machinery, not a speed-up; gloo's "
          "all-reduce and all-gather took the card's tensors directly on every rank)")
    return out


def phase_mesh_din(plain: dict, ranks: list) -> list:
    """[32]: DIN through ``FederatedTrainer(mesh=...)``, 2 ranks, 10 rounds;
    ``auto`` picks ``union`` at 63,001 x 18 f32 (4.5 MB): K1 twice per rank
    per round."""
    check(ranks[0]["din fedsubavg auto"]["combine"] == {"item_emb": "union"},
          f"DIN combine {ranks[0]['din fedsubavg auto']['combine']}")
    return check_mesh_trainer(ranks, "din fedsubavg auto", plain["din fedsubavg"])["launches"]


def phase_mesh_steps(ranks: list) -> dict:
    """[33]: ``make_round_step`` on the mesh, two ranks, each mode of
    ``MESH_STEP_MODES`` against its unsharded step on the card; every
    rank's collective counters equal the budget's components."""
    out = {}
    for label, mode, stacked, k, debug in MESH_STEP_MODES:
        r0 = ranks[0]["steps"][label]
        want = 1 if mode == "sparse_replicated" else 0
        for r, rk in enumerate(ranks):
            res = rk["steps"][label]
            check(res["launches"] == [want] * 3,
                  f"{label}: rank {r} K1 {res['launches']}, want {want} per step")
            check(all(res["counters_equal_budget"]),
                  f"{label}: rank {r} collective counters differ from the budget")
        loss_err = max(abs(a - b) for a, b in zip(r0["loss"], r0["plain_loss"]))
        check(loss_err <= 1e-5, f"{label}: losses {loss_err} from the unsharded step's")
        check(params_close(r0["params"], r0["plain_params"], 1e-5),
              f"{label}: parameters {params_diff(r0['params'], r0['plain_params'])} apart")
        spread = max(params_diff(rk["steps"][label]["params"], r0["params"]) for rk in ranks)
        check(spread == 0.0, f"{label}: ranks differ by {spread}")
        out[label] = [rk["steps"][label]["launches"] for rk in ranks]
        print(f"  {label}: loss err {loss_err:.3g}, params err "
              f"{params_diff(r0['params'], r0['plain_params']):.3g}, ranks equal; K1 per "
              f"rank per step {out[label]}; counters = budget on every rank; bytes per "
              f"rank by op {r0['by_op']}; ms/step (rank 0) {[round(x, 1) for x in r0['ms']]}")
    return out


# ---------------------------------------------------------------------------
# [34]-[38]: federated LLM training
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2_5_14b"
LM_LAYERS = 4
#: examples/federated_llm.py's corpus and cohort (``train``'s corpus takes 4
#: samples per client)
LM_CORPUS = dict(clients=256, seq=128, zipf_a=1.3, cohort=16)
LM_LR, LM_ROUNDS = 0.05, 10
LM_REDUCED = ("layers 48 -> 4: 4 layers at full width are 2.66 B f32 parameters "
              "(10.6 GB); parameters, gradients, the update and the new parameters "
              "take ~43 GB of the card's 80, and 48 layers would need ~470 GB")
#: [35]'s plans: FedSgdLocal on the dense and on the row-sparse transport
LM_PLANS = (("fedsubavg dense", "fedsubavg", False), ("fedavg dense", "fedavg", False),
            ("fedsubavg sparse", "fedsubavg", True), ("fedavg sparse", "fedavg", True))
#: card against host at full width ([36]): the sum order of 5,120- and
#: 13,824-long f32 dot products, as [11], and of the 2,048- and 32-token
#: gradient sums; the update scales a gradient by up to N / n_m = 256
LM_HOST_TOL = 1e-4
#: [36]'s update, leaf by leaf: ||(p_card - p0) - (p_host - p0)|| /
#: ||p_host - p0||. Each side rounds p0 + update to f32, an ulp of p0 apart
#: at most, which is large against an update far below p0; a gradient that
#: is zero or lost reads 1 and a wrong one about 1 or more
LM_UPDATE_TOL = 1e-3
#: card against host at the tiny scale ([37]): the repository's 1e-5
LM_STEP_TOL = 1e-5
LM_STEP_MODES = ("fedsgd", "sparse", "replicated", "sparse_replicated")
LM_TRAIN_SHAPE = (LM_CORPUS["cohort"], LM_CORPUS["seq"])
LM_COUNTED = (("flash_attention", flash_attention), ("flash_attention_bwd", flash_attention_bwd),
              ("union_segsum", union_segsum))


def lm_counts() -> dict:
    return {name: w.launches for name, w in LM_COUNTED}


def lm_zero_counts() -> None:
    for _, w in LM_COUNTED:
        w.launches = 0


def lm_config(layers: int = LM_LAYERS, **over):
    return get_config(LM_ARCH).replace(num_layers=layers, dtype="float32", **over)


def lm_params(cfg, device) -> tuple:
    """The flat training dict and its axes, drawn from seed ``SEED``."""
    model = transformer.make_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                                    device)
    return transformer.train_params(model)


def compare_grads(name, got, want, dtype) -> float:
    return max(compare(f"{name}.{g}", a.float(), w.float(), dtype)
               for g, a, w in zip(("dq", "dk", "dv"), got, want))


def phase_k3_bwd(rng) -> tuple:
    """[34] K3 and its backward against their plain versions, case by case
    (tolerance by dtype), and ``FlashAttention`` under ``torch.func.grad``
    and ``vmap`` against autograd of K3's plain version. Returns the worst
    forward and the worst backward error."""
    from torch.func import grad, vmap

    bf, f32 = torch.bfloat16, torch.float32
    b, s = LM_TRAIN_SHAPE
    cases = [("train", b, s, s, 40, 8, 128, True, 0, 0, f32),
             ("train", b, s, s, 40, 8, 128, True, 0, 0, bf),
             ("ragged", 2, 100, 100, 8, 2, 64, True, 0, 0, f32),
             ("ragged", 2, 100, 100, 8, 2, 64, True, 0, 0, bf),
             ("window", 2, 300, 300, 8, 2, 128, True, 70, 0, f32),
             ("window", 2, 300, 300, 8, 2, 128, True, 70, 0, bf),
             ("continue", 2, 77, 200, 8, 2, 32, True, 0, 123, f32),
             ("non-causal", 1, 90, 150, 4, 4, 16, False, 0, 0, f32),
             ("window-nc", 1, 128, 128, 4, 2, 64, False, 40, 0, bf)]
    worst = worst_fwd = 0.0
    for name, b, sq, sk, h, kv, hd, causal, window, off, dtype in cases:
        q, k, v = (normal(rng, (b, sq, h, hd), dtype), normal(rng, (b, sk, kv, hd), dtype),
                   normal(rng, (b, sk, kv, hd), dtype))
        kw = dict(causal=causal, window=window, q_offset=off)
        # the backward below takes the kernel's output: the forward is held
        # to its plain version first, so a wrong ``o`` cannot pass unseen
        o = flash_attention(q, k, v, **kw)
        err_f = compare(f"flash_attention[{name}]", o, flash_attention_torch(q, k, v, **kw),
                        dtype)
        worst_fwd = max(worst_fwd, err_f)
        do = normal(rng, o.shape, dtype)
        err = compare_grads(f"flash_attention_bwd[{name}]",
                            flash_attention_bwd(q, k, v, o, do, **kw),
                            flash_attention_bwd_torch(q, k, v, o, do, **kw), dtype)
        worst = max(worst, err)
        print(f"  K3 and backward {name:10s} {str(dtype):14s} B={b} Sq={sq} Sk={sk} H={h} "
              f"KV={kv} hd={hd} causal={causal} window={window} q_offset={off} "
              f"max_abs_err forward {err_f:.3g}, backward {err:.3g}")

    # FlashAttention through torch.func against autograd of the plain forward
    n, b, s, h, kv, hd = 3, 2, 128, 8, 2, 64
    for dtype in (f32, bf):
        q, k, v = (normal(rng, (n, b, s, h, hd), dtype), normal(rng, (n, b, s, kv, hd), dtype),
                   normal(rng, (n, b, s, kv, hd), dtype))
        w = normal(rng, (b, s, h, hd), dtype)
        fused = lambda q, k, v: (FlashAttention.apply(q, k, v, True, 0, 0, 1024, 1024)  # noqa: E731
                                 * w).float().sum()

        def plain_grads(i):
            leaves = [t[i].clone().requires_grad_() for t in (q, k, v)]
            out = (flash_attention_torch(*leaves) * w).float().sum()
            return torch.autograd.grad(out, leaves)

        g_fn = grad(fused, argnums=(0, 1, 2))
        before = flash_attention_bwd.launches
        got = g_fn(q[0], k[0], v[0])
        torch.cuda.synchronize()
        check(flash_attention_bwd.launches == before + 1, "grad did not launch K3's backward")
        err = compare_grads(f"FlashAttention grad {dtype}", got, plain_grads(0), dtype)
        before = flash_attention_bwd.launches
        got = vmap(g_fn)(q, k, v)
        torch.cuda.synchronize()
        check(flash_attention_bwd.launches == before + 1,
              "vmap(grad) did not fold the clients into one K3 backward launch")
        for i in range(n):
            err = max(err, compare_grads(f"FlashAttention vmap(grad)[{i}] {dtype}",
                                         tuple(g[i] for g in got), plain_grads(i), dtype))
        worst = max(worst, err)
        print(f"  FlashAttention {str(dtype):14s} under grad and vmap(grad) over {n} "
              f"clients (B={b} S={s} H={h} KV={kv} hd={hd}) against autograd of the plain "
              f"forward: max_abs_err={err:.3g}; one launch per call")
    return worst_fwd, worst


def phase_lm_main() -> dict:
    """[35] the main path: ``launch.train.train`` at Qwen2.5-14B's widths,
    4 layers, f32, 10 rounds per plan, each from the seed's weights, with
    every count set to 0 just before it and read just after."""
    cfg = lm_config()
    runs = {}
    for label, alg, sparse in LM_PLANS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_zero_counts()
        # the weights from seed 0 (``SEED``), drawn by ``train`` itself, so
        # that no second copy of them stays alive through the run
        res = train_mod.train(cfg, rounds=LM_ROUNDS, lr=LM_LR, algorithm=alg,
                              sparse=sparse, device=DEV, log_every=0, **LM_CORPUS)
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated()
        if not runs:
            n_params = sum(p.numel() for p in res.params.values())
            print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                  f"{n_params / 1e9:.3f} B params ({cfg.dtype}); reduced: {LM_REDUCED}")
        check(all(math.isfinite(x) for x in res.losses), f"{label}: a loss is not finite")
        nl = cfg.num_layers * LM_ROUNDS
        check(launches == {"flash_attention": nl, "flash_attention_bwd": nl,
                           "union_segsum": 0},
              f"{label}: launches {launches}, want {cfg.num_layers} of K3 and of its "
              "backward per round and no K1 (FedSgdLocal)")
        steady = statistics.median(res.ms_per_round[1:])
        runs[label] = {"losses": res.losses, "ms_per_round": res.ms_per_round,
                       "steady_ms_per_round": steady, "peak_gb": peak / 1e9,
                       "launches": launches, "bytes_up_sparse": res.bytes_up_sparse,
                       "bytes_up_dense": res.bytes_up_dense}
        print(f"  {label} ({res.plan}): loss {[round(x, 4) for x in res.losses]}")
        print(f"    ms/round: first {res.ms_per_round[0]:.1f}, steady {steady:.1f} (median "
              f"of rounds 2-{LM_ROUNDS}); peak device memory {peak / 1e9:.2f} GB; "
              f"launches {launches}")
        if res.bytes_up_sparse:
            print(f"    uplink per round (cohort as one union): "
                  f"{[round(x / 1e6, 2) for x in res.bytes_up_sparse]} MB sparse against "
                  f"{res.bytes_up_dense[-1] / 1e6:.1f} MB dense")
        del res
    return runs


def phase_lm_card_vs_host() -> dict:
    """[36] one round per transport at full width, 1 layer, cohort 2,
    32 tokens, on the card and on the host from the same weights: the loss,
    the parameters, and each leaf's update (parameters after minus before),
    which the parameters' own tolerance cannot see when it is small."""
    cfg = lm_config(1)
    out = {}
    for label, sparse in (("dense", False), ("sparse", True)):
        card, axes = lm_params(cfg, DEV)
        # the round updates sparse tables in place: p0 stays untouched
        p0 = {k: v.to("cpu", copy=True) for k, v in card.items()}
        host = {k: v.clone() for k, v in p0.items()}
        kw = dict(rounds=1, lr=LM_LR, sparse=sparse, axes=axes, log_every=0,
                  **{**LM_CORPUS, "cohort": 2, "seq": 32})
        lm_zero_counts()
        rc = train_mod.train(cfg, device=DEV, params=card, **kw)
        check(lm_counts() == {"flash_attention": 1, "flash_attention_bwd": 1,
                              "union_segsum": 0}, f"card run launches {lm_counts()}")
        del card
        t0 = time.perf_counter()
        rh = train_mod.train(cfg, device="cpu", params=host, **kw)
        host_s = time.perf_counter() - t0
        check(lm_counts()["flash_attention"] == 1, "the host run launched a kernel")
        loss_err = abs(rc.losses[0] - rh.losses[0])
        check(loss_err <= LM_HOST_TOL * max(1.0, abs(rh.losses[0])),
              f"{label}: card and host losses differ by {loss_err}")
        err, upd = 0.0, {}
        for name, want in rh.params.items():
            got = rc.params[name].cpu()
            err = max(err, float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=LM_HOST_TOL, atol=LM_HOST_TOL),
                  f"{label}: {name} differs between card and host by "
                  f"{float((got - want).abs().max())}")
            d_host, d_card = want - p0[name], got - p0[name]
            norm = float(torch.linalg.vector_norm(d_host))
            rel = (float(torch.linalg.vector_norm(d_card - d_host)) / norm if norm
                   else (0.0 if not d_card.any() else math.inf))
            upd[name] = (rel, float(d_host.abs().max()))
            check(rel <= LM_UPDATE_TOL, f"{label}: {name}'s update differs between card and "
                  f"host by {rel:.3g} of its norm (largest update {upd[name][1]:.3g})")
        worst = max(upd, key=lambda n: upd[n][0])
        out[label] = {"loss_diff": loss_err, "param_diff": err,
                      "update_rel_diff": {n: r for n, (r, _) in upd.items()},
                      "update_max_abs": {n: m for n, (_, m) in upd.items()}}
        print(f"  {label}: loss card {rc.losses[0]:.6f} host {rh.losses[0]:.6f} "
              f"(|diff| {loss_err:.3g}); max |param diff| {err:.3g} (tolerance "
              f"{LM_HOST_TOL}); host round {host_s:.1f} s")
        print(f"    update card against host, ||d_card - d_host|| / ||d_host|| by leaf "
              f"(tolerance {LM_UPDATE_TOL}; a zero gradient reads 1): worst {upd[worst][0]:.3g} "
              f"({worst})")
        for name, (rel, big) in upd.items():
            if name.startswith("layers.0.attn") or not name.startswith("layers."):
                print(f"      {name:28s} rel {rel:.3g}, largest |update| {big:.3g}")
        del rc, rh, host, p0
    return out


def lm_step_batches(ds, cohort: int, steps: int, stacked: bool, local_iters: int = 2):
    """``steps`` numpy batches from ``ds``: flat ``(cohort * 4, S)`` pooled
    sequences, or ``(cohort, local_iters, 2, S)`` per-client stacks, each with
    ``heat_vocab``."""
    rng = np.random.default_rng(SEED)
    toks = ds.client_data["tokens"]
    out = []
    for _ in range(steps):
        ids = rng.choice(ds.num_clients, size=cohort, replace=False)
        t = toks[ids]                                        # (K, 4, S)
        t = t.reshape(cohort, local_iters, -1, t.shape[-1]) if stacked else t.reshape(
            -1, t.shape[-1])
        out.append({"tokens": t, "heat_vocab": ds.heat.counts.astype(np.float32)})
    return out


def run_lm_steps(cfg, mode: str, device, batches, clients: int, cohort: int, params,
                 axes) -> tuple:
    """``make_round_step`` in ``mode`` over ``batches`` from ``params`` on
    ``device``; returns losses, ms per step, final parameters and the
    launches, counted from 0."""
    api = build_model(cfg)
    fed = FedConfig(num_clients=clients, clients_per_round=cohort, local_iters=2, lr=LM_LR,
                    algorithm="fedsubavg")
    step = make_round_step(api.loss, params, axes, fed, mode=mode)
    losses, ms = [], []
    lm_zero_counts()
    for b in batches:
        t0 = time.perf_counter()
        params, m = step(params, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, params, lm_counts()


def phase_lm_round_steps() -> dict:
    """[37] ``make_round_step`` at the reference's ``100m`` scale in its four
    modes, K1 counted per step and held to its plain version on the
    ``sparse_replicated`` step's inputs; the same at ``tiny`` on the card and
    on the host."""
    steps, cohort, clients = 3, 4, 64
    out = {}
    for scale in ("100m", "tiny"):
        cfg = get_config(LM_ARCH).replace(**serve_mod.SCALES[scale])
        ds = make_lm_federated(num_clients=clients, vocab=cfg.vocab_size, seq_len=128,
                               samples_per_client=4, zipf_a=LM_CORPUS["zipf_a"])
        for mode in LM_STEP_MODES:
            batches = lm_step_batches(ds, cohort, steps, "replicated" in mode)
            init, axes = lm_params(cfg, DEV)
            host_init = {k: v.to("cpu", copy=True) for k, v in init.items()}
            captured = {}
            ctx = (capture_k1(captured) if mode == "sparse_replicated"
                   else contextlib.nullcontext())
            with ctx:
                losses, ms, params, launches = run_lm_steps(cfg, mode, DEV, batches, clients,
                                                            cohort, init, axes)
            del init
            if captured:
                args = captured["args"]
                ids, rows, v = args[0], args[1], args[5]
                union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
                err = check_k1(f"union_segsum[lm {scale} sparse_replicated step]", args,
                               captured["kw"]["scale"], union)
                out["k1_err"] = max(out.get("k1_err", 0.0), err)
                print(f"  K1 at a {scale} sparse_replicated step: V={v} T={ids.numel()} "
                      f"D={rows.shape[-1]} cap={args[4]} union={union} max_abs_err={err:.3g}")
            check(all(math.isfinite(x) for x in losses), f"{scale} {mode}: loss not finite")
            want_k1 = steps if mode == "sparse_replicated" else 0
            check(launches["union_segsum"] == want_k1,
                  f"{scale} {mode}: K1 launched {launches['union_segsum']} times in {steps} "
                  f"steps, want {want_k1}")
            check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
                  f"{scale} {mode}: K3 or its backward did not launch: {launches}")
            line = (f"  {scale} {mode:17s}: loss {[round(x, 4) for x in losses]}, ms/step "
                    f"{[round(x, 1) for x in ms]}, launches {launches}")
            if scale == "tiny":
                h_losses, _, h_params, h_launches = run_lm_steps(cfg, mode, "cpu", batches,
                                                                 clients, cohort, host_init,
                                                                 axes)
                check(sum(h_launches.values()) == 0, "the host run launched a kernel")
                err = max(float((params[k].cpu() - h_params[k]).abs().max())
                          for k in h_params)
                check(np.allclose(losses, h_losses, rtol=LM_STEP_TOL, atol=LM_STEP_TOL),
                      f"tiny {mode}: card losses {losses} against host {h_losses}")
                check(all(torch.allclose(params[k].cpu(), h_params[k], rtol=LM_STEP_TOL,
                                         atol=LM_STEP_TOL) for k in h_params),
                      f"tiny {mode}: card and host parameters differ by {err}")
                line += f"; card against host: max |param diff| {err:.3g}"
                out[f"tiny {mode} param_diff"] = err
            out[f"{scale} {mode}"] = launches
            print(line)
            del params
    return out


def phase_lm_profile(steady_ms: float, err_bwd: float, launches_bwd: int,
                     k3: dict) -> dict:
    """[38] where one fedsubavg dense round of [35]'s path goes (device ops,
    busy share of [35]'s steady round, device ms by kind), then K3 and its
    backward at the training shape, each first held to its plain version
    there, then timed by CUDA events beside their plain versions, SDPA (its
    backward: autograd of ``scaled_dot_product_attention``, its forward
    subtracted) and the bound. Returns K3-backward's entry and adds K3's
    training-shape times and error to ``k3``."""
    import torch.nn.functional as F

    cfg = lm_config()
    api = build_model(cfg)
    params, axes = lm_params(cfg, DEV)
    k = LM_CORPUS["cohort"]
    ds = make_lm_federated(num_clients=LM_CORPUS["clients"], vocab=cfg.vocab_size,
                           seq_len=LM_CORPUS["seq"], zipf_a=LM_CORPUS["zipf_a"],
                           samples_per_client=4)
    fed = FedConfig(num_clients=ds.num_clients, clients_per_round=k, lr=LM_LR,
                    algorithm="fedsubavg")
    step = make_round_step(api.loss, params, axes, fed, mode=train_mod.make_plan())
    rng = np.random.default_rng(SEED)
    toks = ds.client_data["tokens"]
    ids = rng.choice(ds.num_clients, size=k, replace=False)
    batch = {"tokens": torch.from_numpy(toks[ids, rng.integers(0, toks.shape[1], k)]).to(DEV),
             "heat_vocab": torch.as_tensor(ds.heat.counts, dtype=torch.float32).to(DEV)}
    state = {"params": params}
    del params

    def one_round():
        state["params"], m = step(state["params"], batch)
        float(m["loss"])

    one_round()
    _, by_name, ops = device_profile(one_round)
    device_ms = sum(by_name.values()) / 1e3
    kinds = {"K3": ("attention_kernel",), "K3 backward": ("dq_kernel", "dkv_kernel")}
    split = {kind: sum(t for name, t in by_name.items() if any(w in name for w in ws)) / 1e3
             for kind, ws in kinds.items()}
    split["matmuls"] = matmul_us(by_name) / 1e3
    split["elementwise and the rest"] = device_ms - sum(split.values())
    # cuBLAS's share: forward and backward (2 + 4 flops a weight a token) of
    # every 2-D weight but the embedding, which is gathered, not multiplied
    mm_flops = 6 * batch["tokens"].numel() * sum(
        p.numel() for name, p in state["params"].items() if p.dim() == 2 and name != "embedding")
    del state
    print(f"  fedsubavg dense round: {steady_ms:.1f} ms steady ([35]); {ops} device ops, "
          f"{device_ms:.2f} ms busy ({device_ms / steady_ms * 100:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    print(f"  matmuls: {mm_flops / 1e12:.2f} TFLOP per round from the shapes, "
          f"{mm_flops / split['matmuls'] / 1e9:.1f} TFLOP/s (f32 without TF32; "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s peak)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {t / 1e3:.4f} ms  {name[:90]}")

    rng = np.random.default_rng(SEED + 34)
    b, s = LM_TRAIN_SHAPE
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = torch.float32
    q, k, v = normal(rng, (b, s, h, hd), dtype), normal(rng, (b, s, kvh, hd), dtype), normal(
        rng, (b, s, kvh, hd), dtype)
    o = flash_attention(q, k, v)
    err_fwd = compare("flash_attention[training round shape]", o, flash_attention_torch(q, k, v),
                      dtype)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_fwd)
    do = normal(rng, o.shape, dtype)
    err_bwd = max(err_bwd, compare_grads("flash_attention_bwd[training round shape]",
                                         flash_attention_bwd(q, k, v, o, do),
                                         flash_attention_bwd_torch(q, k, v, o, do), dtype))
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    fwd = lambda: flash_attention(q, k, v)                                  # noqa: E731
    fwd_plain = lambda: flash_attention_torch(q, k, v)                      # noqa: E731
    bwd = lambda: flash_attention_bwd(q, k, v, o, do)                       # noqa: E731
    bwd_plain = lambda: flash_attention_bwd_torch(q, k, v, o, do)           # noqa: E731
    with torch.no_grad():
        f_p1, f1, f2, f_p2 = (cuda_ms(fwd_plain, 5, 1), cuda_ms(fwd, 20), cuda_ms(fwd, 20),
                              cuda_ms(fwd_plain, 5, 1))
        f_lib = cuda_ms(sdpa, 20)
    b_p1, b1, b2, b_p2 = (cuda_ms(bwd_plain, 5, 1), cuda_ms(bwd, 20), cuda_ms(bwd, 20),
                          cuda_ms(bwd_plain, 5, 1))
    b_lib = cuda_ms(sdpa_fwd_bwd, 20) - f_lib
    pairs = s * (s + 1) // 2
    fbytes, fops = attention_work(b, s, h, kvh, hd, s, pairs, dtype)
    f_bound, f_by = attention_bound(fbytes, fops, dtype)
    # the gradient reads q, k, v, o and dout and writes dq, dk and dv: twice
    # the forward's bytes; five products per valid pair: 2.5 times its flops
    b_bound, b_by = attention_bound(2 * fbytes, 2.5 * fops, dtype)
    print(f"  K3 at the training shape B={b} S={s} H={h} KV={kvh} hd={hd} {dtype} causal: "
          f"max_abs_err {err_fwd:.3g}; kernel {f1:.4f}/{f2:.4f} ms, plain {f_p1:.4f}/"
          f"{f_p2:.4f} ms, SDPA {f_lib:.4f} ms, "
          f"bound {f_bound:.5f} ms ({f_by})")
    print(f"  K3 backward: kernel {b1:.4f}/{b2:.4f} ms ({2.5 * fops / min(b1, b2) / 1e9:.1f} "
          f"TFLOP/s), plain {b_p1:.4f}/{b_p2:.4f} ms, SDPA backward {b_lib:.4f} ms, bound "
          f"{b_bound:.5f} ms ({b_by}; {OPS_PER_S[dtype] / 1e12:.0f} TFLOP/s)")
    k3["training"] = {"shape": [b, s, h, kvh, hd], "dtype": "float32",
                      "ms": min(f1, f2), "plain_ms": min(f_p1, f_p2), "library_ms": f_lib,
                      "bound_ms": f_bound, "bound_by": f_by,
                      "launches_main_path": k3["launches_by_path"]["training"],
                      "max_abs_err": err_fwd,
                      "device_ms_per_round": split["K3"]}
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:154",
            "launches": launches_bwd, "max_abs_err": err_bwd,
            "ms": min(b1, b2), "plain_ms": min(b_p1, b_p2), "bound_ms": b_bound,
            "bound_by": b_by, "library_ms": b_lib,
            "device_ms_per_round": split["K3 backward"],
            "round_split_ms": split, "round_device_ops": ops,
            "round_matmul_tflop": mm_flops / 1e12}


def phase_lm_training(kernels: list, rng, k1: dict) -> list:
    """[34]-[38], each timed; returns K3-backward's kernel entry (K3's gains
    its training numbers, K1's its launches on [37]'s steps)."""
    print("[34] K3 and its backward vs plain versions; FlashAttention under grad and vmap")
    t0 = time.perf_counter()
    k3 = next(e for e in kernels if e["name"] == "flash_attention")
    err_fwd, err_bwd = phase_k3_bwd(rng)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_fwd)
    print(f"  [34] took {time.perf_counter() - t0:.1f} s")

    print(f"[35] federated LLM training: {LM_ARCH} at its published widths, {LM_LAYERS} "
          f"layers, f32, {LM_CORPUS}, {LM_ROUNDS} rounds per plan")
    t0 = time.perf_counter()
    lm_runs = phase_lm_main()
    print(f"  [35] took {time.perf_counter() - t0:.1f} s")

    print("[36] card vs host: 1 layer at full width, f32, cohort 2, 32 tokens, one round "
          "per transport")
    t0 = time.perf_counter()
    phase_lm_card_vs_host()
    print(f"  [36] took {time.perf_counter() - t0:.1f} s")

    print("[37] make_round_step on the LLM at the 100m scale in four modes; card vs host "
          "at the tiny scale")
    t0 = time.perf_counter()
    steps = phase_lm_round_steps()
    for mode in LM_STEP_MODES:
        k1["launches_by_path"][f"lm 100m make_round_step {mode}"] = steps[
            f"100m {mode}"]["union_segsum"]
    k1["max_abs_err"] = max(k1["max_abs_err"], steps["k1_err"])
    print(f"  [37] took {time.perf_counter() - t0:.1f} s")

    print("[38] where a training round's time goes; K3 and its backward at the training "
          "shape")
    t0 = time.perf_counter()
    k3["launches_by_path"] = {
        "serving prefill": k3["launches"],
        "training": sum(r["launches"]["flash_attention"] for r in lm_runs.values())}
    launches_bwd = sum(r["launches"]["flash_attention_bwd"] for r in lm_runs.values())
    entry = phase_lm_profile(lm_runs["fedsubavg dense"]["steady_ms_per_round"],
                             err_bwd, launches_bwd, k3)
    print(f"  [38] took {time.perf_counter() - t0:.1f} s")
    return [entry]


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
    lr_ds = ds
    runs, launches_k1, captured = phase_main_path(ds)
    lr_runs = runs
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
    del params, captured

    deep = {}
    for n, make, kw, title, reduced in (
            (15, make_amazon_like, DIN_DATA, "DIN FedSubAvg at Amazon Electronics' "
             "63,001 goods (D = 18)", DIN_REDUCED),
            (16, make_sent140_like, LSTM_DATA, "LSTM FedSubAvg on Sent140-like data "
             "(D = 25)", LSTM_REDUCED)):
        print(f"[{n}] {title}")
        t0 = time.perf_counter()
        ds = make(**kw)
        print(f"  data: {ds.stats()} V={ds.num_features} "
              f"({time.perf_counter() - t0:.1f} s to generate)")
        print(f"  reduced: {reduced}")
        deep[ds.task] = (ds,) + phase_deep_path(ds)
        print(f"  [{n}] took {time.perf_counter() - t0:.1f} s")
    check(deep["din"][0].num_features == 63_001, "DIN's V must be 63,001")

    print("[17] card vs host, DIN and LSTM, 200 clients, 3 rounds")
    t0 = time.perf_counter()
    for make, kw in ((make_amazon_like, DIN_DATA), (make_sent140_like, LSTM_DATA)):
        phase_card_vs_host(make(**{**kw, "num_clients": 200}), rounds=3)
    print(f"  [17] took {time.perf_counter() - t0:.1f} s")

    print("[18] where a DIN and an LSTM fedsubavg round's time goes; K1 at their rounds")
    t0 = time.perf_counter()
    k1 = kernels[0]
    check(k1["name"] == "union_segsum", "the first kernel entry is K1's")
    k1["launches_by_path"] = {"lr": launches_k1}
    for task, (ds, runs, launches, cap, err) in deep.items():
        prof = phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"],
                             n=3 if task == "lstm" else 5)
        timed = time_k1_k2(cap["args"], cap["kw"]["scale"], f"{task} round", keys=("k1",),
                           profiled={"k1": (prof["k1_device_ops_per_round"],
                                            prof["k1_device_ms_per_round"])})
        k1[f"{task}_round"] = {"shape": timed["shape"], **timed["k1"]}
        k1["launches_by_path"][task] = launches
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [18] took {time.perf_counter() - t0:.1f} s")

    print("[19] Table 2's algorithms at MovieLens-1M width: scaffold and fedadam "
          "(sparse and dense), dense fedsubavg, central SGD")
    t0 = time.perf_counter()
    _, protocol_launches, err = phase_protocol_paths(lr_ds)
    for label in ("scaffold sparse", "fedadam sparse"):
        k1["launches_by_path"]["lr " + label] = protocol_launches[label]
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [19] took {time.perf_counter() - t0:.1f} s")

    print("[20] private and weighted heat at MovieLens-1M width, fedsubavg sparse")
    t0 = time.perf_counter()
    phase_private_heat(lr_ds)
    print(f"  [20] took {time.perf_counter() - t0:.1f} s")

    print("[21] card vs host, 200 clients, 3 rounds: scaffold and fedadam sparse, "
          "fedsubavg dense, central, randomized-response fedsubavg")
    t0 = time.perf_counter()
    small = make_movielens_like(num_clients=200, num_items=3706, mean_samples=165,
                                seed=SEED)
    phase_card_vs_host(small, rounds=3, cases=(
        ("scaffold sparse", "scaffold", dict(server_lr=1.0)),
        ("fedadam sparse", "fedadam", dict(server_lr=0.03)),
        ("fedsubavg dense", "fedsubavg", dict(sparse=False)),
        ("central", "central", dict(sparse=False)),
        ("fedsubavg randomized response", "fedsubavg",
         dict(heat_estimator="randomized_response"))))
    print(f"  [21] took {time.perf_counter() - t0:.1f} s")

    print("[22] Table 2 and Table 3 through the port (tools/paper_tables.py)")
    t0 = time.perf_counter()
    for sparse in (False, True):
        out = tables(sparse=sparse, device=DEV)
        check(all(math.isfinite(r["best"]) for r in out["table2"] + out["table3"]),
              "a table's best loss is not finite")
        print_tables(out, sparse, card)
    print(f"  [22] took {time.perf_counter() - t0:.1f} s")

    print("[23] ReplicatedLocal x RowSparseTransport through the trainer at MovieLens-1M "
          "width")
    t0 = time.perf_counter()
    rep_runs, rep_launches, err = phase_replicated(lr_ds, lr_runs)
    for alg, n in rep_launches.items():
        k1["launches_by_path"][f"lr replicated {alg}"] = n
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [23] took {time.perf_counter() - t0:.1f} s")

    print("[24] int8 rows through the trainer at MovieLens-1M width")
    t0 = time.perf_counter()
    f32_runs = {"f32": lr_runs["fedsubavg"], "f32 top-16": lr_runs["fedsubavg_top16"],
                "f32 replicated": rep_runs["fedsubavg"]}
    f32_runs["f32 top-16 replicated"] = drive(
        make_trainer(lr_ds, "fedsubavg", DEV, sparse_topk=16, sparse_local="replicated"),
        "f32 top-16 replicated")
    _, int8_launches = phase_int8(lr_ds, f32_runs, rng)
    for label, n in int8_launches.items():
        k1["launches_by_path"][f"lr {label}"] = n
    print(f"  [24] took {time.perf_counter() - t0:.1f} s")

    print("[25] make_round_step on the LSTM at [16]'s width: four modes, microbatches, "
          "int8, debug checks, gather before backward at V = 2^22")
    t0 = time.perf_counter()
    steps = phase_round_steps(deep["lstm"][0])
    for label in ("sparse_replicated", "int8 sparse_replicated"):
        k1["launches_by_path"][f"lstm make_round_step {label}"] = steps["launches"][label]
    k1["max_abs_err"] = max(k1["max_abs_err"], steps["k1_err"])
    print(f"  [25] took {time.perf_counter() - t0:.1f} s")

    print("[26] card vs host, 200 clients, 3 rounds: replicated, int8, make_round_step; "
          "Example 1")
    t0 = time.perf_counter()
    phase_new_card_vs_host(small, make_sent140_like(**{**LSTM_DATA, "num_clients": 200}))
    print(f"  [26] took {time.perf_counter() - t0:.1f} s")

    print("[27] round telemetry at MovieLens-1M width: on against off, the JSONL sink, "
          "first dispatches, the LSTM step bit for bit, a planted capacity")
    t0 = time.perf_counter()
    tel = phase_telemetry(lr_ds, deep["lstm"][0])
    for label, n in tel["launches"].items():
        k1["launches_by_path"][f"lr {label}"] = n
    print(f"  [27] took {time.perf_counter() - t0:.1f} s")

    print("[28] run(profile_dir=...): the trace, its round ranges and K1's events")
    t0 = time.perf_counter()
    phase_profile_dir(lr_ds)
    print(f"  [28] took {time.perf_counter() - t0:.1f} s")

    print("[29] the buffered-async engine at MovieLens-1M width")
    t0 = time.perf_counter()
    asyn = phase_async(lr_ds, tel["off"]["ms_per_round"])
    for label, n in asyn["launches"].items():
        k1["launches_by_path"][f"lr async {label}"] = n
    k1["async_fire"] = asyn["k1"]
    k1["max_abs_err"] = max(k1["max_abs_err"], asyn["k1"]["max_abs_err"])
    print(f"  [29] took {time.perf_counter() - t0:.1f} s")

    print("[30] card vs host: the async engine on 200 clients, K = 20, 6 waves; a mid-run "
          "checkpoint saved on the card and resumed on the host")
    t0 = time.perf_counter()
    phase_async_card_vs_host(small)
    print(f"  [30] took {time.perf_counter() - t0:.1f} s")

    print("[31] LR through FederatedTrainer(mesh=...) at MovieLens-1M width: 1 rank "
          "(NCCL), 2 and 4 ranks (gloo) on the one card")
    t0 = time.perf_counter()
    plain, mesh_ranks = phase_mesh_runs(lr_ds, deep["din"][0], deep["lstm"][0])
    mesh_lr = phase_mesh_lr(plain, mesh_ranks)
    for label, per_rank in mesh_lr["launches"].items():
        k1["launches_by_path"][f"lr mesh {label}"] = per_rank
    for (args, kw), tag in zip(mesh_lr["k1_calls"], ("mesh_partial", "mesh_union")):
        args = tuple(a.to(DEV) if torch.is_tensor(a) else a for a in args)
        ids, rows, v = args[0], args[1], args[5]
        union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                check_k1(f"union_segsum[{tag}]", args, kw["scale"], union))
        timed = time_k1_k2(args, kw["scale"], f"LR x2 union, {tag}", keys=("k1",),
                           profile=False)
        k1[tag] = {"shape": timed["shape"], **{f: timed["k1"][f] for f in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
    print(f"  [31] took {time.perf_counter() - t0:.1f} s (with [32] and [33]'s runs)")

    print("[32] DIN through FederatedTrainer(mesh=...), 2 ranks: the union combine")
    k1["launches_by_path"]["din mesh x2 fedsubavg union"] = phase_mesh_din(
        plain, mesh_ranks[2])

    print("[33] make_round_step on the mesh, 2 ranks, on the LSTM's inputs: four modes, a "
          "cohort that does not divide, debug checks; collectives against the budget")
    for label, per_rank in phase_mesh_steps(mesh_ranks[2]).items():
        k1["launches_by_path"][f"lstm mesh x2 make_round_step {label}"] = per_rank
    del plain, mesh_ranks

    kernels += phase_lm_training(kernels, rng, k1)
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
