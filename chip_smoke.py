#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which asserts; any failure exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN (both stated here: every comparison below is in
   full float32), build the CUDA kernels from ``src/repro_torch/kernels/csrc``
2. K1 ``union_segsum`` against its plain PyTorch version on the card, at
   the trainer's shapes and a wide shape, f32 and bf16, with and without
   heat, ids >= V, all-pad clients and an overflowing union
3. K2 ``rowsparse_scatter`` against its plain version on the card
4. the main path at full width: LR FedSubAvg on MovieLens-1M-sized data
   (6,040 clients, 3,706 movies, ~1.0M ratings, V = 37,069 features),
   K = 100 clients per round, fedsubavg, fedavg and fedsubavg with top-16
   transport, 20 rounds each through ``run_round`` and ``run``; K1 must
   serve every round. K2's own path (``aggregate_rowsparse_dense``) follows
5. card against host: the same trainer for 5 rounds on ``device="cpu"``
   (the plain versions); losses and final parameters within 1e-5
6. kernel times (CUDA events) beside their plain versions, one PyTorch
   stand-in each and the HBM bound
7. where a round's time goes: host sampling, device kernel time and
   launches per round (torch.profiler), the device's busy share

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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.heat_scatter import (rowsparse_scatter,  # noqa: E402
                                              rowsparse_scatter_torch)
from repro_torch.kernels.union_segsum import (union_segsum,  # noqa: E402
                                              union_segsum_torch)
from repro_torch.models.recsys import lr_logits, lr_loss, make_lr_params  # noqa: E402
from repro_torch.sparse import aggregate as aggregate_mod  # noqa: E402
from repro_torch.sparse.aggregate import aggregate_rowsparse_dense  # noqa: E402
from repro_torch.sparse.rowsparse import RowSparse  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:14-15
SEED = 0
N_CLIENTS = 6040               # MovieLens-1M users: the heat total N
DEV = torch.device("cuda")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cohort(rng, k: int, r: int, v: int, d: int, dtype, all_pad: int = 0,
           out_of_range: float = 0.0):
    """A cohort of per-client sorted unique ids (-1 padded) with hot ids
    shared across clients, its rows, and heat counts.

    Heat is consistent with the cohort, as a real n_m is: an id that c of
    the k sampled clients touch has heat about c * N / k (plus noise), so
    the correction ``N / n_m`` is large only on ids few rows sum into. (With
    heat unrelated to the cohort, a hot id could sum many rows that cancel
    and then be scaled by hundreds, and the f32 sum order that the atomics
    change would show far above the tolerance.)
    """
    hot = max(v // 50, 16)
    ids = np.full((k, r), -1, np.int32)
    for i in range(all_pad, k):
        n = int(rng.integers(r // 2, r + 1))
        pick = np.concatenate([rng.integers(0, hot, n // 2),
                               rng.integers(0, v, n - n // 2)])
        u = np.unique(pick)
        ids[i, :len(u)] = u
    touched = np.bincount(ids[ids >= 0], minlength=v)
    heat = (touched * (N_CLIENTS / k) + rng.integers(0, 60, v)).astype(np.float32)
    if out_of_range:
        hit = (ids >= 0) & (rng.random(ids.shape) < out_of_range)
        ids[hit] = v + rng.integers(0, 1000, int(hit.sum()))
    rows = rng.normal(size=(k, r, d)).astype(np.float32) * (ids >= 0)[..., None]
    return (torch.from_numpy(ids).to(DEV),
            torch.from_numpy(rows).to(DEV, dtype),
            torch.from_numpy(heat).to(DEV))


def compare(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = TOL[dtype]
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def phase_k1(rng) -> float:
    v, k, r = 37_069, 100, 128
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("main", v, k, r, 1, dtype, {}, True, None))
        cases.append(("wide", 262_144, 16, 2_048, 16, dtype, {}, True, None))
    cases += [
        ("no-heat", v, k, r, 1, torch.float32, {}, False, None),
        ("ids>=V", v, k, r, 1, torch.float32, {"out_of_range": 0.05}, True, None),
        ("all-pad", v, k, r, 1, torch.float32, {"all_pad": 10}, True, None),
        ("overflow", v, k, r, 1, torch.float32, {}, True, "half"),
    ]
    worst = 0.0
    for name, vv, kk, rr, d, dtype, kw, with_heat, cap in cases:
        ids, rows, heat = cohort(rng, kk, rr, vv, d, dtype, **kw)
        heat = heat if with_heat else None
        union = int(torch.unique(ids[(ids >= 0) & (ids < vv)]).numel())
        c = union // 2 if cap == "half" else min(vv, kk * rr)
        args = (ids, rows, heat, float(N_CLIENTS), c, vv)
        got_ids, got_rows = union_segsum(*args, scale=1.0 / kk)
        want_ids, want_rows = union_segsum_torch(*args, scale=1.0 / kk)
        torch.cuda.synchronize()
        check(torch.equal(got_ids, want_ids), f"union_segsum[{name}]: ids differ")
        check(int((got_ids >= 0).sum()) == min(union, c),
              f"union_segsum[{name}]: union size")
        err = compare(f"union_segsum[{name}]", got_rows, want_rows, dtype)
        worst = max(worst, err)
        print(f"  K1 {name:8s} {str(dtype):14s} V={vv} T={kk * rr} D={d} cap={c} "
              f"union={union} max_abs_err={err:.3g}")
    return worst


def phase_k2(rng) -> float:
    worst = 0.0
    for v, k, r, d in ((37_069, 100, 128, 1), (65_536, 16, 2_048, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            ids, rows, heat = cohort(rng, k, r, v, d, dtype)
            args = (ids.reshape(-1), rows.reshape(k * r, d), heat, float(N_CLIENTS), v)
            got = rowsparse_scatter(*args, scale=1.0 / k)
            want = rowsparse_scatter_torch(*args, scale=1.0 / k)
            err = compare("rowsparse_scatter", got, want, dtype)
            worst = max(worst, err)
            print(f"  K2 {str(dtype):14s} V={v} T={k * r} D={d} max_abs_err={err:.3g}")
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
    from torch.autograd import DeviceType
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
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
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
    return out


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(k1_args, launches_k1: int, launches_k2: int, err_k1: float,
                 err_k2: float) -> list:
    ids, rows, heat, total, cap, v = k1_args
    flat_ids, flat_rows = ids.reshape(-1), rows.reshape(ids.numel(), -1)
    t, d = flat_rows.shape
    k = 100
    scale = 1.0 / k
    # the main path's own round, kernel against plain version once more
    union_ids, want_rows = union_segsum_torch(*k1_args, scale=scale)
    got_ids, got_rows = union_segsum(*k1_args, scale=scale)
    check(torch.equal(got_ids, union_ids), "union_segsum[trainer round]: ids differ")
    err_k1 = max(err_k1, compare("union_segsum[trainer round]", got_rows,
                                 want_rows, flat_rows.dtype))
    n_union = int((union_ids >= 0).sum())
    esize = flat_rows.element_size()

    def k1_library():
        u, inv = torch.unique(flat_ids, sorted=True, return_inverse=True)
        out = torch.zeros((u.numel(), d), device=DEV).index_add_(0, inv, flat_rows)
        h = heat[u.clamp(min=0)]
        f = torch.where(h > 0, total / h.clamp(min=1.0), 0.0) * scale
        return u, out * torch.where(u >= 0, f, 0.0)[:, None]

    def k2_library():
        keep = flat_ids >= 0
        out = torch.zeros((v, d), device=DEV).index_add_(
            0, flat_ids.clamp(min=0).long(), flat_rows * keep[:, None])
        f = torch.where(heat > 0, total / heat.clamp(min=1.0), 0.0)
        return out * f[:, None] * scale

    k1 = lambda: union_segsum(*k1_args, scale=scale)               # noqa: E731
    k1_plain = lambda: union_segsum_torch(*k1_args, scale=scale)   # noqa: E731
    k2 = lambda: rowsparse_scatter(flat_ids, flat_rows, heat, total, v, scale=scale)  # noqa: E731
    k2_plain = lambda: rowsparse_scatter_torch(flat_ids, flat_rows, heat, total, v,  # noqa: E731
                                               scale=scale)
    # in turns, plain / kernel / kernel / plain, so drift cannot favour one
    p1, m1, m2, p2 = cuda_ms(k1_plain), cuda_ms(k1), cuda_ms(k1), cuda_ms(k1_plain)
    lib1 = cuda_ms(k1_library)
    q1, n1, n2, q2 = cuda_ms(k2_plain), cuda_ms(k2), cuda_ms(k2), cuda_ms(k2_plain)
    lib2 = cuda_ms(k2_library)
    # least bytes each function must move: ids and rows read once, heat at
    # the union's rows, outputs written once; ops: one add per row element
    # and one scale per output element
    b1, by1 = bound(4 * t + esize * t * d + 4 * n_union + 4 * cap + 4 * cap * d,
                    t * d + cap * d)
    b2, by2 = bound(4 * t + esize * t * d + 4 * n_union + 4 * v * d,
                    t * d + 2 * v * d)
    print(f"  K1 union_segsum  V={v} T={t} D={d} cap={cap} union={n_union}: "
          f"kernel {m1:.4f}/{m2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
          f"unique+index_add {lib1:.4f} ms, bound {b1:.5f} ms ({by1})")
    print(f"  K2 rowsparse_scatter V={v} T={t} D={d}: kernel {n1:.4f}/{n2:.4f} ms, "
          f"plain {q1:.4f}/{q2:.4f} ms, index_add {lib2:.4f} ms, "
          f"bound {b2:.5f} ms ({by2})")
    return [
        {"name": "union_segsum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/union_segsum.cu",
         "replaces": "src/repro/kernels/union_segsum.py:170",
         "launches": launches_k1, "max_abs_err": err_k1,
         "ms": min(m1, m2), "plain_ms": min(p1, p2), "bound_ms": b1,
         "bound_by": by1, "library_ms": lib1},
        {"name": "rowsparse_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rowsparse_scatter.cu",
         "replaces": "src/repro/kernels/heat_scatter.py:138",
         "launches": launches_k2, "max_abs_err": err_k2,
         "ms": min(n1, n2), "plain_ms": min(q1, q2), "bound_ms": b2,
         "bound_by": by2, "library_ms": lib2},
    ]


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
            if "registers" in line or "error" in line.lower():
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
                           max(err_k2, err_k2_path))

    print("[7] where a fedsubavg round's time goes")
    phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"])
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
