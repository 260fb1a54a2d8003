"""Memory and comm-drift oracle over a round step as it really ran.

The port's counterpart of ``repro/analysis/hlo_audit.py``. The reference
reads a compiled XLA executable; the port runs eagerly, so it measures one
round step instead:

- :func:`memory_budget` — the reference's analytic per-device live-byte
  budget of one round step, its six components term by term (params in and
  out, the batch, one f32 copy of every table, the ``K_shard * capacity``
  submodel working set, the combine buffers, activations), from the port's
  ``heat_spec_from_axes``, ``sparse_table_paths``, ``round_capacity`` and
  ``split_heat_batch``; optionally a seventh, each client's copy of the
  dense leaves and its activations, priced from the same shapes.
- :func:`memory_contract` — gates a step's peak device memory against that
  budget at the reference's tolerance (25% relative plus 1 MiB): on the
  card, ``torch.cuda.max_memory_allocated`` over one step with its
  arguments resident, counted from the bytes allocated before it plus the
  arguments' own. ``measured`` can be passed in instead, so the gate's
  arithmetic runs anywhere. A dense-replica regression (``K_shard * V *
  row`` instead of ``K_shard * capacity * row``) blows through it.
- :func:`comm_drift` — the bytes a cohort-sharded step's collectives really
  moved (``CohortMesh.by_op()``, ``repro_torch/launch/mesh.py``) against
  the comm plane's own prediction (``sparse.comm.sharded_combine_bytes`` of
  ``plan_comm_meta``), at the reference's tolerance of 10% plus 64 B (the
  absolute term covers the 4-byte loss and sub-row reductions the comm
  plane does not price). The collective half of the reference's oracle is
  ``federated.plan.round_collective_budget``, which the mesh's counters
  equal (``tests/test_torch_sharding.py``).

CLI::

    python -m repro_torch.analysis.hlo_audit --device cpu --json report.json

runs the reference's ``{sparse, sparse_replicated} x {fedavg, fedsubavg} x
{psum, union}`` matrix on the LSTM over gloo ranks spawned on this host
(``launch.mesh.spawn_ranks``; ``--device cuda`` puts every rank's tensors
on the card, which also measures memory) and exits non-zero on any
failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import ServerState
from repro_torch.federated.plan import (build_round_step, heat_spec_from_axes,
                                        plan_comm_meta, round_capacity,
                                        round_collective_budget, sparse_table_paths,
                                        split_heat_batch)
from repro_torch.sparse.comm import sharded_combine_bytes

__all__ = ["MemoryReport", "DriftReport", "memory_budget", "memory_contract",
           "measure_step_memory", "comm_drift", "main"]


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel()) * x.element_size()
    arr = np.asarray(x)
    return float(arr.size) * arr.dtype.itemsize


# ---------------------------------------------------------------------------
# memory contract
# ---------------------------------------------------------------------------


@dataclass
class MemoryReport:
    """Peak bytes of one step against the analytic budget."""

    plan: str
    measured_bytes: int
    budget_bytes: float
    components: Dict[str, float]
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> Dict:
        return {"plan": self.plan, "ok": self.ok, "measured_bytes": self.measured_bytes,
                "budget_bytes": self.budget_bytes, "components": self.components,
                "failures": self.failures}


def memory_budget(plan, axes: Dict, params: Dict[str, torch.Tensor], cfg, batch: Dict, *,
                  sub_ids: Optional[torch.Tensor] = None,
                  clients: bool = False) -> Dict[str, float]:
    """Analytic per-rank live-byte budget of one round step.

    The reference's components, term by term (f32 working set, int32 ids):

    - ``params_io``: the parameters twice (argument and fresh output);
    - ``batch``: the whole round batch, heat vectors included;
    - ``tables_scratch``: one f32 copy of every feature table (the psum
      combine's densified partial, the apply's scratch);
    - ``replicas``: ``4 * k_shard * capacity * (row + id)``, the submodel
      working set with gradient, delta and optimizer temporaries; a dense
      replica plan costs ``k_shard * V * row`` here instead;
    - ``combine``: the cross-rank union buffers plus a V-sized workspace;
    - ``activations``: 4x the batch bytes.

    These model the reference's audit models (an LSTM of hidden 8), whose
    dense leaves are a few hundred floats. At a model's full widths each
    client of a stacked plan also trains its own copy of the dense leaves
    on its own activations, which none of the six prices. ``clients=True``
    adds a seventh component, ``clients``, priced from the plan's shapes
    alone: ``k_shard`` times the dense leaves' bytes at the ``replicas``
    term's factor of 4 (replica, gradient, delta, optimizer temporaries),
    plus one local step's activations, ``2 * 4 B * tokens * widths``
    (``tokens``: the ids a client's local step reads, ``B * S`` of a
    ``(K, I, B, S)`` feature; ``widths``: the output widths of the dense
    leaves of two or more dimensions; 2: each product's output, kept for
    the backward, and its gradient). Left off, the dict is the
    reference's.
    """
    sharding = plan.sharding
    ndev = sharding.num_shards if sharding is not None else 1
    table_paths = [p for p, _ in sparse_table_paths(heat_spec_from_axes(axes))]
    tables = [params[p] for p in table_paths]
    vocab = max((int(t.shape[0]) for t in tables), default=0)
    param_bytes = sum(_nbytes(x) for x in params.values())
    _, data = split_heat_batch(batch)
    batch_bytes = sum(_nbytes(v) for v in batch.values())

    fk = tuple(plan.feature_keys)
    row_elems = sum(max(math.prod(t.shape[1:]), 1) for t in tables)
    stacked = getattr(plan.local, "stacked", False)
    if sub_ids is not None:
        cap = int(sub_ids.shape[-1])
    elif stacked:
        cap = round_capacity(vocab, sum(math.prod(data[k].shape[1:]) for k in fk)) \
            if vocab else 0
    else:
        cap = round_capacity(vocab, sum(math.prod(data[k].shape) // ndev for k in fk)) \
            if vocab else 0
    k_shard = -(-int(data[fk[0]].shape[0]) // ndev) if stacked else 1
    comps = {
        "params_io": 2.0 * param_bytes,
        "batch": batch_bytes,
        "tables_scratch": sum(float(math.prod(t.shape)) * 4.0 for t in tables),
        "replicas": 4.0 * k_shard * cap * (row_elems * 4.0 + 4.0),
        "combine": float(ndev) * cap * (row_elems * 4.0 + 4.0) + float(vocab) * 8.0,
        "activations": 4.0 * batch_bytes,
    }
    if clients:
        dense = [x for p, x in params.items() if p not in table_paths]
        ids = data[fk[0]].shape
        tokens = math.prod(ids[2:]) if stacked else math.prod(ids) // ndev
        widths = sum(int(x.shape[-1]) for x in dense if x.dim() >= 2)
        comps["clients"] = float(k_shard) * (
            4.0 * sum(float(x.numel()) * 4.0 for x in dense) + 2.0 * 4.0 * tokens * widths)
    return comps


def measure_step_memory(step, state: ServerState, batch: Dict, sub_ids=None) -> int:
    """Peak device bytes of one call of a built round step on the card: the
    allocator's peak over the call above what was allocated before it, plus
    the bytes of the arguments (parameters, optimizer slots, batch, ids),
    which are resident throughout. One call on a copy of the parameters
    comes first, so that one-time allocations (cuBLAS's workspace, 64 MiB
    on the H100 at a process's first matmul) are not counted, and the
    allocator's cache is emptied after it, so that the step's blocks are
    cut from fresh segments and not from whatever earlier work left free
    (a cached block is handed out whole when the remainder would be under
    1 MiB, and counts whole)."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_memory reads the card's allocator and no CUDA "
                           "device is available: pass measured= to memory_contract")
    args = [*state.params.values(), *batch.values()]
    args += [x for x in (state.opt if isinstance(state.opt, (list, tuple)) else [])
             if isinstance(x, torch.Tensor)]
    if sub_ids is not None:
        args.append(sub_ids)
    if any(not (isinstance(x, torch.Tensor) and x.is_cuda) for x in args
           if isinstance(x, torch.Tensor)):
        raise ValueError("measure_step_memory: the step's arguments must be resident on "
                         "the card")
    warm = ServerState({k: v.clone() for k, v in state.params.items()}, state.opt, state.rounds)
    step(warm, batch) if sub_ids is None else step(warm, batch, sub_ids)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(state, batch) if sub_ids is None else step(state, batch, sub_ids)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak + sum(_nbytes(x) for x in args))


def memory_contract(plan, loss_fn, axes: Dict, params: Dict[str, torch.Tensor], cfg,
                    batch: Dict, *, sub_ids=None, measured: Optional[int] = None,
                    budget: Optional[Dict] = None, slack_rel: float = 0.25,
                    slack_abs: float = float(1 << 20)) -> MemoryReport:
    """Gate one step's peak device bytes against the analytic budget.

    ``measured`` defaults to :func:`measure_step_memory` of the step built
    from ``plan`` on the card (``params`` and ``batch`` resident there; the
    table rows of ``params`` are updated in place, as the trainer's are).
    ``budget`` defaults to :func:`memory_budget` of this plan; the planted
    check passes a leaner plan's budget to show a dense-replica regression
    trips the gate.
    """
    if measured is None:
        step = build_round_step(plan, loss_fn, axes, params, cfg)
        measured = measure_step_memory(step, ServerState(params, (), 0), batch, sub_ids)
    comps = memory_budget(plan, axes, params, cfg, batch, sub_ids=sub_ids) \
        if budget is None else budget
    allowed = sum(comps.values()) * (1.0 + slack_rel) + slack_abs
    failures = []
    if measured > allowed:
        top = max(comps, key=comps.get)
        failures.append(
            f"peak live bytes {measured} exceed the analytic budget "
            f"{sum(comps.values()):.0f} B (+{slack_rel:.0%}/+{slack_abs:.0f} B slack; "
            f"largest budget term '{top}' = {comps[top]:.0f} B) — a dense-replica or "
            "table-copy regression")
    return MemoryReport(plan=plan.describe(), measured_bytes=int(measured),
                        budget_bytes=allowed, components=comps, failures=failures)


# ---------------------------------------------------------------------------
# comm-accounting drift
# ---------------------------------------------------------------------------


@dataclass
class DriftReport:
    """Counted combine bytes against the comm plane's own prediction."""

    plan: str
    predicted_by_op: Dict[str, float]
    measured_by_op: Dict[str, float]
    rel_tol: float
    abs_tol: float
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> Dict:
        return {"plan": self.plan, "ok": self.ok, "predicted_by_op": self.predicted_by_op,
                "measured_by_op": self.measured_by_op, "rel_tol": self.rel_tol,
                "abs_tol": self.abs_tol, "failures": self.failures}


def comm_drift(plan, axes: Dict, params: Dict[str, torch.Tensor], cfg, batch: Dict, *,
               sub_ids=None, measured: Optional[Dict[str, float]] = None,
               rel_tol: float = 0.10, abs_tol: float = 64.0) -> DriftReport:
    """Hold what a sharded step's collectives moved to ``sharded_combine_bytes``.

    ``measured`` is the step's bytes by collective kind, by default the
    plan's mesh's ``by_op()`` right after the step (a sharded step resets
    its counters when it starts). The prediction prices the combine from
    the comm plane's own primitives (``plan_comm_meta`` and
    ``sharded_combine_bytes``), not from the plan compiler's budget, so a
    change to one that forgets the other fails here.
    """
    budget = round_collective_budget(plan, axes, params, cfg, batch, sub_ids=sub_ids)
    modes = set(budget["combine"].values())
    if len(modes) != 1:
        raise ValueError(
            f"comm_drift prices one combine mode per plan, got {modes}: a dense transport "
            "has none, and split per-table modes need round_collective_budget")
    mode = modes.pop()
    predicted = sharded_combine_bytes(
        plan_comm_meta(params, axes), budget["vocab"], max(budget["capacity"].values()),
        budget["num_shards"], mode, num_tables=len(budget["combine"]),
        count_gather_ids=not budget["stacked"])
    if measured is None:
        measured = plan.sharding.mesh.by_op()
    failures = []
    for op in sorted(set(predicted) | set(measured)):
        p, m = predicted.get(op, 0.0), measured.get(op, 0.0)
        if abs(m - p) > rel_tol * p + abs_tol:
            failures.append(
                f"'{op}': comm plane predicts {p:.0f} B, the step's collectives moved "
                f"{m:.0f} B (tolerance {rel_tol:.0%} + {abs_tol:.0f} B) — the byte "
                "accounting and the plan compiler have drifted apart")
    return DriftReport(plan=plan.describe(), predicted_by_op=predicted,
                       measured_by_op=dict(measured), rel_tol=rel_tol, abs_tol=abs_tol,
                       failures=failures)


# ---------------------------------------------------------------------------
# CLI: the matrix on gloo ranks
# ---------------------------------------------------------------------------


def _audit_matrix(mesh, vocab: int, emb: int, device: torch.device) -> List[Dict]:
    """Counters, drift and (on the card) memory over the sharded sparse plan
    matrix on the LSTM, the reference's batches and seeds."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.federated.plan import CohortSharding, resolve_plan
    from repro_torch.models.recsys import lstm_loss, make_lstm_params

    params0, axes = make_lstm_params(vocab, emb_dim=emb, hidden=8, layers=1, device="cpu",
                                     generator=torch.Generator().manual_seed(1))
    params0 = {k: v.to(device) for k, v in params0.items()}
    rng = np.random.default_rng(0)

    def tensors(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def heat():
        return np.maximum(rng.integers(0, 6, vocab).astype(np.float32), 0)

    def cohort_batch(k=3, i=2, b=2, s=6):
        return tensors({"tokens": rng.integers(-1, vocab, (k, i, b, s)).astype(np.int32),
                        "label": rng.integers(0, 2, (k, i, b)).astype(np.int32),
                        "heat_vocab": heat()})

    def flat_batch(b=8, s=8):
        return tensors({"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
                        "label": rng.integers(0, 2, b).astype(np.int32),
                        "heat_vocab": heat()})

    results = []
    for mode in ("sparse", "sparse_replicated"):
        for alg in ("fedavg", "fedsubavg"):
            for combine in ("psum", "union"):
                fed = FedConfig(num_clients=16, clients_per_round=3, local_iters=2,
                                lr=0.1, algorithm=alg)
                plan = dataclasses.replace(
                    resolve_plan(mode, fed, correct=(alg == "fedsubavg")),
                    sharding=CohortSharding(mesh, combine=combine))
                batch = flat_batch() if mode == "sparse" else cohort_batch()
                params = {k: v.clone() for k, v in params0.items()}
                budget = round_collective_budget(plan, axes, params, fed, batch)
                step = build_round_step(plan, lstm_loss, axes, params, fed)
                state = ServerState(params, (), 0)
                if device.type == "cuda":
                    measured = measure_step_memory(step, state, batch)
                    mem = memory_contract(plan, lstm_loss, axes, params0, fed, batch,
                                          measured=measured).to_dict()
                else:
                    step(state, batch)
                    mem = None          # the host has no device allocator to read
                counters = dict(mesh.counters)
                drift = comm_drift(plan, axes, params0, fed, batch,
                                   measured=mesh.by_op()).to_dict()
                con_ok = counters == budget["components"]
                results.append({
                    "mode": mode, "algorithm": alg, "combine": combine,
                    "counters": counters, "budget": budget["components"],
                    "counters_equal_budget": con_ok, "memory": mem, "drift": drift,
                    "ok": con_ok and drift["ok"] and (mem is None or mem["ok"])})
    return results


def _matrix_rank(rank: int, world: int, store: str, out: str, vocab: int, emb: int,
                 device: str) -> None:
    """One gloo rank of :func:`main`; rank 0 writes the results to ``out``."""
    from repro_torch.launch.mesh import make_cohort_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    mesh = make_cohort_mesh(device=dev if dev.type == "cpu" else torch.device("cuda", 0),
                            backend="gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        results = _audit_matrix(mesh, vocab, emb, mesh.device)
        if rank == 0:
            Path(out).write_text(json.dumps(results))
        mesh.barrier()
    finally:
        mesh.destroy()


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(
        description="memory and comm-drift oracle over sharded round steps on gloo ranks")
    ap.add_argument("--json", default=None, help="write the report to this path")
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--emb", type=int, default=8)
    ap.add_argument("--world", type=int, default=2, help="gloo ranks to spawn")
    ap.add_argument("--device", default=None,
                    help="'cpu' for host tensors; the card by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "results.json"
        spawn_ranks(_matrix_rank, args.world,
                    args=(args.world, str(Path(tmp) / "store"), str(out), args.vocab,
                          args.emb, device.type), timeout_s=600.0)
        results = json.loads(out.read_text())
    report = {"world": args.world, "device": device.type, "vocab": args.vocab,
              "emb": args.emb, "results": results, "ok": all(r["ok"] for r in results)}
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2, sort_keys=True))
    for r in results:
        tag = f"{r['mode']}/{r['algorithm']}/{r['combine']}"
        peak = ("not measured (host)" if r["memory"] is None
                else f"{r['memory']['measured_bytes']} B of {r['memory']['budget_bytes']:.0f}")
        print(f"hlo_audit {'OK' if r['ok'] else 'FAIL':4s} {tag}: counted "
              f"{r['drift']['measured_by_op']}, predicted {r['drift']['predicted_by_op']}, "
              f"peak {peak}")
        if not r["counters_equal_budget"]:
            print(f"  counters {r['counters']} != budget {r['budget']}", file=sys.stderr)
        for section in ("memory", "drift"):
            for msg in (r[section] or {}).get("failures", []):
                print(f"  {section}: {msg}", file=sys.stderr)
    if not report["ok"]:
        bad = sum(not r["ok"] for r in results)
        print(f"hlo_audit: {bad}/{len(results)} plan contracts FAILED", file=sys.stderr)
        return 1
    print(f"hlo_audit: all {len(results)} plan contracts hold ({args.world} ranks, "
          f"{device.type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
