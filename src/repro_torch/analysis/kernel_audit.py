"""Kernel contract plane: launch resources, cross-block state and cost of the
Hopper kernels.

The port's counterpart of ``repro/analysis/kernel_audit.py``. The reference
reads each ``pallas_call``'s BlockSpecs and body; a CUDA kernel has none, so
its three contracts become:

- :func:`resource_contract` (the reference's ``vmem_contract``): each kernel
  instance a call launches, at its real launch configuration, against
  sm_90's limits (``common/hw.py``) and its own ``__launch_bounds__``. Two
  sources of numbers: ptxas's ``-v`` lines of the build
  (:func:`parse_ptxas`: registers, stack frame, spill stores and loads,
  static shared memory), and the runtime on the card, read through the
  ``<source>_instance`` query every source exports (``csrc/introspect.cuh``:
  ``cudaFuncGetAttributes`` after the launcher's own
  ``cudaFuncSetAttribute``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
  and ``cudaOccupancyMaxActiveClusters`` at the launcher's threads, dynamic
  shared memory and cluster, and ``cudaFuncGetName``, which ties the
  instance to its ptxas lines). A query in the source, not the Python
  runtime bindings, because only the library that holds a kernel can name
  it to the runtime. Named failures: ``[ptxas-missing]``, ``[spill]``,
  ``[registers]``, ``[smem]``, ``[threads]``, ``[occupancy]`` (fewer
  resident blocks than the declared minimum), ``[cooperative-grid]`` (more
  blocks than can be resident at once) and ``[cluster]`` (over 8, not
  dividing the GQA group, or none resident).
- :func:`state_contract` (the reference's ``race_contract``): on the host,
  each launch plan's grid covers its work exactly once (K4's slices,
  K1/K2's teams, blocks and union words, K3's query tiles, the backward's
  clusters); on the card (:func:`grid_invariance`), the result does not
  depend on the grid beyond what the kernel declares: K1 and K2 at two
  cooperative grid sizes (ids exact, rows within 2e-5: their atomics sum in
  a varying order), K4 at two split counts (2e-5 in f32; 2e-2 and 1e-2 in
  relative norm in bf16) and bit for bit twice at one, K3 and its backward
  twice, bit for bit (nothing crosses blocks, or a cluster sums in a fixed
  order). The card side calls each source's launcher through
  ``_build.launcher`` with its own plan, and adds no option to the public
  wrappers (whose launch counters it leaves alone).
- :func:`cost_model` (the reference's ``cost_model``): the least bytes and
  flops a call must move and do, and its bound in ms at ``HW``'s rates: the
  pricing ``chip_smoke.py`` prints and ``PERF.md`` §6 tabulates.

``registry_coverage`` fails when a ``__global__`` function of ``csrc/*.cu``
or a symbol of ``_build.SIGNATURES`` has no registry entry.

CLI (on the card)::

    python -m repro_torch.analysis.kernel_audit --json kernel-audit.json

exits non-zero on any failure; ``--plant`` {cluster, grid, spill,
coverage} plants one breaker into what the audit measured
(:func:`planted_failures`), and its gate must fail.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.common.hw import HW
from repro_torch.kernels.introspect import REGISTRY, KernelEntry, Launch, launches

__all__ = [
    "PtxasInfo", "InstanceResources", "ResourceReport", "StateReport", "CostReport",
    "KernelReport", "parse_ptxas", "declared_min_blocks", "resource_contract",
    "plan_coverage", "state_contract", "grid_invariance", "cost_model", "roofline",
    "query_instance", "audit_kernel", "audit_all", "registry_coverage", "planted_failures",
    "print_reports", "main",
]

TOL = {"f32": 2e-5, "bf16": 2e-2}     # kernel against kernel, as against the plain versions
BF16_REL_TOL = 1e-2
_FIELDS = ("regs", "local_bytes", "static_smem", "max_threads", "dyn_smem", "threads",
           "blocks_per_sm", "sms", "cluster", "clusters", "ptx", "binary")


# ---------------------------------------------------------------------------
# ptxas -v
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PtxasInfo:
    """ptxas's ``-v`` account of one entry function."""

    regs: int
    stack: int
    spill_stores: int
    spill_loads: int
    smem: int            # static shared memory


def parse_ptxas(log: str) -> Dict[str, PtxasInfo]:
    """Every entry function of an ``nvcc -Xptxas -v`` log, by mangled name."""
    out: Dict[str, PtxasInfo] = {}
    entry = None
    props = (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, props = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry is not None:
            props = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = PtxasInfo(int(m.group(1)), *props,
                                   smem=int(smem.group(1)) if smem else 0)
            entry = None
    return out


def declared_min_blocks(global_name: str, csrc: Optional[Path] = None) -> int:
    """The minimum resident blocks per SM that ``global_name``'s
    ``__launch_bounds__`` declares (1 when it declares none), its constant
    resolved from the sources' ``constexpr int`` definitions."""
    if csrc is None:
        from repro_torch.kernels import _build
        csrc = _build.CSRC
    texts = [p.read_text() for p in sorted(csrc.glob("*.cu*"))]
    for text in texts:
        m = re.search(r"__global__\s+void\s+(?:__launch_bounds__\(([^)]*)\)\s+)?"
                      + re.escape(global_name) + r"\s*\(", text)
        if not m:
            continue
        args = [a.strip() for a in (m.group(1) or "").split(",") if a.strip()]
        if len(args) < 2:
            return 1
        value = args[1].split("::")[-1]
        if value.isdigit():
            return int(value)
        for t in texts:
            d = re.search(r"constexpr\s+int\s+" + re.escape(value) + r"\s*=\s*(\d+)\s*;", t)
            if d:
                return int(d.group(1))
        raise ValueError(f"cannot resolve {args[1]!r} in {global_name}'s __launch_bounds__")
    raise KeyError(f"no __global__ {global_name} in {csrc}")


# ---------------------------------------------------------------------------
# contract 1: launch resources
# ---------------------------------------------------------------------------


@dataclass
class InstanceResources:
    """One launched instance: the runtime's numbers at its launch
    configuration, ptxas's, and the plan's grid."""

    kernel: str
    launch: Launch
    mangled: str
    attrs: Dict[str, int]              # _FIELDS from <source>_instance
    ptxas: Optional[PtxasInfo]
    min_blocks: int                    # declared by __launch_bounds__

    def to_dict(self) -> Dict:
        p = self.ptxas
        return {"instance": self.launch.label, "mangled": self.mangled,
                "grid": list(self.launch.grid), "cooperative": self.launch.cooperative,
                "cluster": self.launch.cluster, "min_blocks": self.min_blocks,
                **self.attrs,
                "ptxas": dataclasses.asdict(p) if p is not None else None}


@dataclass
class ResourceReport:
    kernel: str
    instance: str
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def resource_contract(res: InstanceResources, hw: Dict = HW) -> ResourceReport:
    """Hold one launched instance to sm_90's limits and its own bounds."""
    a, lab = res.attrs, f"{res.kernel} {res.launch.label}"
    f: List[str] = []
    p = res.ptxas
    if p is None:
        f.append(f"[ptxas-missing] {lab}: no ptxas -v record for "
                 f"{res.mangled or 'the instance (the runtime gave no name)'} in the build's log")
    elif p.spill_stores or p.spill_loads:
        f.append(f"[spill] {lab}: ptxas spills {p.spill_stores} B of stores and "
                 f"{p.spill_loads} B of loads ({p.regs} registers, {p.stack} B stack frame)")
    if a["regs"] > hw["regs_per_thread"]:
        f.append(f"[registers] {lab}: {a['regs']} registers a thread > {hw['regs_per_thread']}")
    smem = a["static_smem"] + a["dyn_smem"]
    if smem > hw["smem_per_block"]:
        f.append(f"[smem] {lab}: {a['static_smem']} B static + {a['dyn_smem']} B dynamic "
                 f"shared memory = {smem} B > {hw['smem_per_block']} B a block")
    if a["threads"] > min(a["max_threads"], hw["threads_per_block"]):
        f.append(f"[threads] {lab}: launched with {a['threads']} threads, the instance "
                 f"takes at most {a['max_threads']}")
    if a["blocks_per_sm"] < max(res.min_blocks, 1):
        f.append(f"[occupancy] {lab}: {a['blocks_per_sm']} resident blocks an SM at its "
                 f"launch, its __launch_bounds__ declare at least {res.min_blocks}")
    coop = res.launch.cooperative
    if coop and coop > a["blocks_per_sm"] * a["sms"]:
        f.append(f"[cooperative-grid] {lab}: a cooperative grid of {coop} blocks, only "
                 f"{a['blocks_per_sm']} x {a['sms']} = {a['blocks_per_sm'] * a['sms']} "
                 "can be resident at once")
    c = res.launch.cluster
    if c > hw["max_cluster"]:
        f.append(f"[cluster] {lab}: a cluster of {c} blocks > the portable "
                 f"{hw['max_cluster']}")
    if c > 1 and res.launch.groups % c:
        f.append(f"[cluster] {lab}: a cluster of {c} does not divide the GQA group "
                 f"of {res.launch.groups}")
    if 1 < c <= hw["max_cluster"] and a["clusters"] < 1:
        f.append(f"[cluster] {lab}: no cluster of {c} can be resident")
    return ResourceReport(res.kernel, res.launch.label, f)


# ---------------------------------------------------------------------------
# contract 2: state across blocks
# ---------------------------------------------------------------------------


@dataclass
class StateReport:
    kernel: str
    shape: str
    deterministic: bool
    crosses: str
    grid_error: Optional[float] = None          # the card's grid-invariance error
    detail: str = ""
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> Dict:
        return {"kernel": self.kernel, "shape": self.shape, "ok": self.ok,
                "deterministic": self.deterministic, "crosses": self.crosses,
                "grid_error": self.grid_error, "detail": self.detail,
                "failures": self.failures}


def _covers(spans: Sequence, total: int) -> bool:
    """Whether half-open ``spans`` cover ``[0, total)`` exactly once."""
    pos = 0
    for lo, hi in sorted(s for s in spans if s[1] > s[0]):
        if lo != pos:
            return False
        pos = hi
    return pos == total


def plan_coverage(e: KernelEntry, shape: Dict, plan: Sequence[Launch]) -> List[str]:
    """Host half of :func:`state_contract`: each launch plan covers its
    work exactly once."""
    from repro_torch.kernels import _rows
    from repro_torch.kernels.flash_decode import TILE

    f: List[str] = []
    lab = e.name
    if lab in ("union_segsum", "rowsparse_scatter"):
        (ln,) = plan
        d = shape["D"]
        vec = _rows.vector_width(d, 0, 4)       # rows on a 16-byte boundary
        team = _rows.team_size(d, vec)
        if d % vec or team & (team - 1) or team > 32 or _rows.THREADS % team:
            f.append(f"[plan] {lab}: a team of {team} lanes at {vec} elements does not tile "
                     f"rows of {d} and blocks of {_rows.THREADS}")
        if ln.cooperative < 1:
            f.append(f"[plan] {lab}: an empty cooperative grid")
        if e.name == "union_segsum":
            words, blocks = -(-shape["V"] // 32), ln.cooperative
            chunk = -(-words // blocks)
            spans = [(min(words, b * chunk), min(words, min(words, b * chunk) + chunk))
                     for b in range(blocks)]
            if not _covers(spans, words):
                f.append(f"[plan] {lab}: the blocks' spans of the {words} union words do not "
                         "cover them exactly once")
    elif e.name == "flash_decode":
        split = plan[0]
        nsplit, chunk, s = split.grid[0], split.arg, shape["S"]
        if chunk % TILE or not _covers([(i * chunk, min(s, (i + 1) * chunk))
                                         for i in range(nsplit)], s):
            f.append(f"[plan] {lab}: {nsplit} slices of {chunk} slots do not cover the "
                     f"{s} slots exactly once in whole tiles of {TILE}")
        groups = shape["H"] // shape["KV"]
        if split.grid[1] * 8 < shape["KV"] * groups:
            f.append(f"[plan] {lab}: the split grid's {split.grid[1]} head chunks miss heads")
    elif e.name == "flash_attention_bwd":
        dq, dkv = plan
        if dq.grid[0] * 64 < shape["Sq"] or (dq.grid[0] - 1) * 64 >= shape["Sq"]:
            f.append(f"[plan] {lab}: dQ's {dq.grid[0]} row tiles do not cover Sq = {shape['Sq']}")
        c, groups = dkv.cluster, dkv.groups
        heads = sorted(r + j * c for r in range(c) for j in range(groups // c)) \
            if c and groups % c == 0 else []
        if heads != list(range(groups)):
            f.append(f"[plan] {lab}: a cluster of {c} does not share the group of {groups} "
                     "heads exactly once")
        if dkv.grid[0] != -(-shape["Sk"] // 64) * c:
            f.append(f"[plan] {lab}: the dK/dV grid is not a cluster per key tile")
    else:   # the attention forward kernels
        (ln,) = plan
        rows = 128 if e.name == "flash_attention_bf16" else 64
        tiles = -(-shape["Sq"] // rows)
        items = tiles * (1 if rows == 64 else shape["B"] * shape["H"])
        if rows == 64 and ln.grid != (tiles * shape["H"] * shape["B"], 1, 1):
            f.append(f"[plan] {lab}: the grid {ln.grid} is not one block per 64 query rows, "
                     "head and batch")
        if rows == 128 and not 1 <= ln.grid[0] <= items:
            f.append(f"[plan] {lab}: {ln.grid[0]} persistent blocks for {items} work items")
    return f


def state_contract(e: KernelEntry, shape_name: str, shape: Dict, plan: Sequence[Launch],
                   grid: Optional[Dict] = None) -> StateReport:
    """The host's coverage checks, and the card's grid-invariance result
    (:func:`grid_invariance`) where it is given."""
    rep = StateReport(e.name, shape_name, e.deterministic, e.crosses)
    rep.failures += plan_coverage(e, shape, plan)
    if grid is not None:
        rep.grid_error, rep.detail = grid["error"], grid["detail"]
        rep.failures += grid["failures"]
    return rep


def _close(name: str, got, want, dtype: str) -> tuple:
    """(max abs error, failures) of ``got`` against ``want`` at ``TOL``."""
    import torch

    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    tol = TOL[dtype]
    f = []
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        f.append(f"[grid-dependence] {name}: max abs error {err:.3g} > {tol}")
    if dtype == "bf16" and got.numel():
        rel = float(torch.linalg.vector_norm((got - want).float())
                    / torch.linalg.vector_norm(want.float()).clamp(min=1e-30))
        if rel > BF16_REL_TOL:
            f.append(f"[grid-dependence] {name}: relative error {rel:.3g} > {BF16_REL_TOL}")
    return err, f


def _same(name: str, a, b) -> tuple:
    import torch

    err = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    return err, ([] if torch.equal(a, b) else
                 [f"[nondeterministic] {name}: two identical launches differ by {err:.3g}; "
                  "the kernel claims its result does not depend on the run"])


def grid_invariance(e: KernelEntry, shape: Dict, device=None, seed: int = 0) -> Dict:
    """Card half of :func:`state_contract`: launch ``e``'s source at
    ``shape`` through its launcher as the wrapper plans it and as a
    smaller or different grid would run it, on inputs from ``seed``, and
    compare. Returns ``{"error", "detail", "failures"}``."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _build, _rows
    from repro_torch.kernels.flash_attention import _scale, bwd_cluster
    from repro_torch.kernels.flash_decode import TILE, split_plan

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("grid_invariance launches the kernels: it needs the card")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(seed)
    stream = lambda: _rows.raw_stream(dev)  # noqa: E731
    s = shape
    dt = torch.bfloat16 if s.get("dtype") == "bf16" else torch.float32

    def randn(*size, dtype=dt):
        return torch.randn(size, generator=g, device=dev).to(dtype)

    if e.name in ("union_segsum", "rowsparse_scatter"):
        t, d, v = s["T"], s["D"], s["V"]
        ids = torch.randint(-1, v, (t,), generator=g, device=dev, dtype=torch.int32)
        rows = randn(t, d)
        heat = torch.randint(0, 6, (v,), generator=g, device=dev).float()
        bf16 = int(dt == torch.bfloat16)
        vec = _rows.vector_width(d, rows.data_ptr(), rows.element_size())
        full = _rows.max_blocks(e.source, dev, bool(bf16), vec)
        outs = []
        if e.name == "union_segsum":
            cap = s["cap"]
            plans = [_rows.union_plan(t, d, v, cap, vec, full)]
            plans.append(_rows.union_plan(t, d, v, cap, vec, max(1, plans[0].blocks // 4)))
            for plan in plans:
                out_rows = torch.empty((cap, d), device=dev)
                at = cap + cap % 2
                buf = torch.empty(at + plan.scratch_ints, dtype=torch.int32, device=dev)
                err = _build.launcher(e.source, "union_segsum_launch")(
                    ids.data_ptr(), rows.data_ptr(), bf16, heat.data_ptr(), 1000.0, 1 / 16,
                    t, d, v, cap, plan.vec, plan.team, plan.blocks, buf.data_ptr() + 4 * at,
                    buf.data_ptr(), out_rows.data_ptr(), dev.index, stream())
                _build.check(e.source, err)
                outs.append((buf[:cap].clone(), out_rows))
            f = [] if torch.equal(outs[0][0], outs[1][0]) else [
                f"[grid-dependence] {e.name}: the union's ids differ between grids of "
                f"{plans[0].blocks} and {plans[1].blocks} blocks"]
            err, f2 = _close(f"{e.name} rows", outs[1][1], outs[0][1], "f32")
        else:
            plans = [_rows.scatter_plan(t, d, v, vec, full)]
            plans.append(_rows.scatter_plan(t, d, v, vec, max(1, plans[0].blocks // 4)))
            for plan in plans:
                out = torch.empty((v, d), device=dev)
                err = _build.launcher(e.source, "rowsparse_scatter_launch")(
                    ids.data_ptr(), rows.data_ptr(), bf16, heat.data_ptr(), 1000.0, 1 / 16,
                    t, d, v, plan.vec, plan.team, plan.blocks, out.data_ptr(), dev.index,
                    stream())
                _build.check(e.source, err)
                outs.append(out)
            f, (err, f2) = [], _close(f"{e.name} table", outs[1], outs[0], "f32")
        torch.cuda.synchronize(dev)
        return {"error": err, "failures": f + f2,
                "detail": f"cooperative grids of {plans[0].blocks} and {plans[1].blocks} blocks"}

    if e.name == "flash_decode":
        b, h, kvh, sl, hd = s["B"], s["H"], s["KV"], s["S"], s["hd"]
        q, kc, vc = randn(b, h, hd), randn(b, kvh, sl, hd), randn(b, kvh, sl, hd)
        kpos = torch.arange(sl, dtype=torch.int32, device=dev)
        nsplit, chunk = split_plan(b, kvh, h // kvh, sl)
        other = 2 * chunk if nsplit > 1 else TILE
        splits = [(nsplit, chunk), (nsplit, chunk), (-(-sl // other), other)]
        outs = []
        for ns, ch in splits:
            # the log-sum-exp instance writes f32 o beside the rows' lse
            out = torch.empty(q.shape, dtype=torch.float32 if s.get("lse") else q.dtype,
                              device=dev)
            lse = torch.empty((b, h), device=dev) if s.get("lse") else None
            part = torch.empty((b, h, ns, hd + 2), device=dev)
            err = _build.launcher(e.source, "flash_decode_launch")(
                q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kpos.data_ptr(),
                int(dt == torch.bfloat16), b, h, kvh, sl, hd, sl - 1, 0, ns, ch,
                float(np.sqrt(np.float32(hd))),
                part.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(e.source, err)
            outs.append(out if lse is None else torch.cat([out, lse[..., None]], dim=-1))
        torch.cuda.synchronize(dev)
        _, f = _same(f"{e.name} at {nsplit} slices", outs[0], outs[1])
        # the log-sum-exp instance's o is f32, but another cut of the cache
        # rounds p to bf16 against another slice's max: the inputs' dtype's
        # tolerance, as the rounded output's
        err, f2 = _close(f"{e.name} at {nsplit} against {splits[2][0]} slices", outs[2],
                         outs[0], s["dtype"])
        return {"error": err, "failures": f + f2,
                "detail": f"{nsplit} slices of {chunk} slots against {splits[2][0]} of "
                          f"{splits[2][1]}"}

    # K3 and its backward: twice each, bit for bit
    b, sq, sk, h, kvh, hd = s["B"], s["Sq"], s["Sk"], s["H"], s["KV"], s["hd"]
    causal = int(s["causal"])
    if e.name == "flash_attention_bwd":
        dt = torch.bfloat16 if s["dtype"] == "bf16" else torch.float32
    q, k, v = randn(b, sq, h, hd, dtype=dt), randn(b, sk, kvh, hd, dtype=dt), \
        randn(b, sk, kvh, hd, dtype=dt)
    fwd = "flash_attention_bf16_launch" if dt == torch.bfloat16 else "flash_attention_f32_launch"
    st = torch.cuda.current_stream(dev).cuda_stream

    def forward():
        o = torch.empty_like(q)
        lse = torch.empty((b, h, sq), device=dev)
        _build.check("flash_attention", _build.launcher("flash_attention", fwd)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq,
            sk, h, kvh, hd, _scale(hd), causal, 0, 0, st))
        return o, lse

    if e.name != "flash_attention_bwd":
        (o1, l1), (o2, l2) = forward(), forward()
        torch.cuda.synchronize(dev)
        err, f = _same(f"{e.name} output", o1, o2)
        err2, f2 = _same(f"{e.name} log-sum-exp", l1, l2)
        return {"error": max(err, err2), "failures": f + f2,
                "detail": "two launches, output and log-sum-exp bit for bit"}
    o, lse = forward()
    dout = randn(b, sq, h, hd, dtype=dt)
    symbol = ("flash_attention_bwd_bf16_launch" if dt == torch.bfloat16
              else "flash_attention_bwd_f32_launch")
    cluster = bwd_cluster(h, kvh)
    grads = []
    for _ in range(2):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dsum = torch.empty((b, h, sq, 2), device=dev)
        _build.check(e.source, _build.launcher(e.source, symbol)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), b,
            sq, sk, h, kvh, hd, _scale(hd), causal, 0, 0, cluster, st))
        grads.append((dq, dk, dv))
    torch.cuda.synchronize(dev)
    errs, f = [], []
    for name, a, c in zip(("dq", "dk", "dv"), grads[0], grads[1]):
        err, fx = _same(f"{e.name} {name}", a, c)
        errs.append(err)
        f += fx
    return {"error": max(errs), "failures": f,
            "detail": f"two launches, dQ, dK and dV bit for bit (cluster {cluster})"}


# ---------------------------------------------------------------------------
# contract 3: cost model
# ---------------------------------------------------------------------------


@dataclass
class CostReport:
    """Least bytes and flops of one call, and its bound on the card."""

    kernel: str
    bytes: float
    flops: float
    bound_ms: float
    bound_by: str                 # "bytes" or "operations"
    rate: str                     # the HW peak the flops are priced at
    extra: Dict = field(default_factory=dict)

    @property
    def peak(self) -> float:
        """That peak in FLOP/s."""
        return HW[_RATE[self.rate]]


_RATE = {"f32": "peak_flops_f32", "bf16": "peak_flops_bf16", "tf32": "peak_flops_tf32"}
_ESIZE = {"f32": 4, "bf16": 2}


def _dtype(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return {"float32": "f32", "bfloat16": "bf16"}.get(name, name)


def roofline(nbytes: float, flops: float, rate: str = "f32", hw: Dict = HW) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM rate
    and the flops at ``rate``'s peak (f32 on the CUDA cores, bf16 or tf32
    on the tensor cores)."""
    t_bytes = nbytes / hw["hbm_bandwidth"] * 1e3
    t_ops = flops / hw[_RATE[rate]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_work(b, sq, h, kv, hd, keys, pairs, esize, extra_bytes=0) -> tuple:
    """q and o (``sq`` rows), k and v (``keys`` rows) and ``extra_bytes``
    moved once; two products of 2 * hd flops for each valid (query, key)
    pair of each (batch, head)."""
    return (esize * 2 * b * hd * (sq * h + keys * kv) + extra_bytes, 4 * b * h * hd * pairs)


def cost_model(kernel: str, hw: Dict = HW, **s) -> CostReport:
    """Least bytes and flops one call of ``kernel`` must move and do, and
    its bound in ms by ``hw``. Each input is read once and each output
    written once; work that depends on the data is counted as this call's
    data needs it (``n_union`` ids in the union, ``pairs`` valid (query,
    key) pairs, ``n_valid`` valid cache slots).

    - ``union_segsum`` (t, d, cap, n_union, dtype, heat=True; num_rows and
      blocks add K1's scratch): ids and rows read, heat at the union, the
      outputs written; one add per row element and one scale per output
      element, at the f32 rate.
    - ``rowsparse_scatter`` (t, d, v, n_union, dtype): ids and rows read,
      heat at the union, the dense table written; an add per row element
      and two passes over the table.
    - ``flash_attention`` (b, sq, h, kv, hd, keys, pairs, dtype) at the
      dtype's peak (bf16: tensor cores; f32: CUDA cores); for f32 also
      ``extra["route_ms"]`` on its route, 3xTF32 on the tensor cores (each
      product 3 TF32 products).
    - ``flash_decode`` (b, h, kv, hd, n_valid, slots, dtype, lse=False): one
      query row against ``n_valid`` slots, the ``slots`` positions read;
      ``lse``: the log-sum-exp instance, o written in f32 and the rows'
      log-sum-exp beside it.
    - ``flash_attention_bwd`` (b, sq, h, kv, hd, keys, pairs): the forward's
      bytes twice (q, k, v, o, dout read; dq, dk, dv written) and the
      log-sum-exp, five products a valid pair (2.5 times the forward's
      flops); bound on the f32 CUDA cores, and ``extra["route_ms"]`` on its
      route, 3xTF32 on the tensor cores (each product 3 TF32 products).
    """
    if kernel in ("union_segsum", "rowsparse_scatter"):
        t, d, n_union = s["t"], s["d"], s["n_union"]
        esize = _ESIZE[_dtype(s.get("dtype", "f32"))]
        extra: Dict = {}
        if kernel == "union_segsum":
            cap = s["cap"]
            heat = 4 * n_union if s.get("heat", True) else 0
            nbytes = 4 * t + esize * t * d + heat + 4 * cap + 4 * cap * d
            flops = t * d + cap * d
            if "num_rows" in s and "blocks" in s:
                extra["scratch_bytes"] = 4 * (2 * -(-s["num_rows"] // 32) + s["blocks"])
        else:
            v = s["v"]
            nbytes = 4 * t + esize * t * d + 4 * n_union + 4 * v * d
            flops = t * d + 2 * v * d
        ms, by = roofline(nbytes, flops, "f32", hw)
        return CostReport(kernel, float(nbytes), float(flops), ms, by, "f32", extra)
    dtype = _dtype(s.get("dtype", "f32"))
    esize = _ESIZE[dtype]
    if kernel == "flash_decode":
        lse = 4 * s["b"] * s["h"] * (1 + s["hd"]) - esize * s["b"] * s["h"] * s["hd"] \
            if s.get("lse") else 0
        nbytes, flops = _attention_work(s["b"], 1, s["h"], s["kv"], s["hd"], s["n_valid"],
                                        s["n_valid"], esize, 4 * s["slots"] + lse)
        ms, by = roofline(nbytes, flops, dtype, hw)
        return CostReport(kernel, float(nbytes), float(flops), ms, by, dtype)
    fbytes, fflops = _attention_work(s["b"], s["sq"], s["h"], s["kv"], s["hd"], s["keys"],
                                     s["pairs"], esize)
    if kernel == "flash_attention":
        ms, by = roofline(fbytes, fflops, dtype, hw)
        extra = {}
        if dtype == "f32":
            route, route_by = roofline(fbytes, 3 * fflops, "tf32", hw)
            extra = {"route_ms": route, "route_by": route_by, "route_rate": "3xTF32"}
        return CostReport(kernel, float(fbytes), float(fflops), ms, by, dtype, extra)
    if kernel == "flash_attention_bwd":
        nbytes, flops = 2 * fbytes + 4 * s["b"] * s["h"] * s["sq"], 2.5 * fflops
        ms, by = roofline(nbytes, flops, dtype, hw)
        route, route_by = roofline(nbytes, 3 * flops, "tf32", hw)
        return CostReport(kernel, float(nbytes), float(flops), ms, by, dtype,
                          {"route_ms": route, "route_by": route_by, "route_rate": "3xTF32"})
    raise KeyError(f"no cost model for {kernel!r}")


# ---------------------------------------------------------------------------
# per-entry audit, coverage, CLI
# ---------------------------------------------------------------------------


@dataclass
class KernelReport:
    """Every contract of one entry at one audit shape."""

    name: str
    shape: str
    origin: str
    resources: List[InstanceResources]
    resource_reports: List[ResourceReport]
    state: StateReport

    @property
    def failures(self) -> List[str]:
        return [x for r in self.resource_reports for x in r.failures] + self.state.failures

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> Dict:
        return {"name": self.name, "shape": self.shape, "origin": self.origin,
                "ok": self.ok, "instances": [r.to_dict() for r in self.resources],
                "state": self.state.to_dict(), "failures": self.failures}


def query_instance(source: str, launch: Launch) -> tuple:
    """(attributes, mangled name) of ``launch`` from ``<source>_instance``
    on the current card."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * len(_FIELDS))()
    name = ctypes.c_char_p()
    err = _build.launcher(source, f"{source}_instance")(launch.index, launch.arg, out,
                                                         ctypes.byref(name))
    _build.check(f"{source}_instance({launch.index}, {launch.arg})", err)
    return dict(zip(_FIELDS, list(out))), (name.value or b"").decode()


def audit_kernel(e: KernelEntry, shape_name: str, shape: Dict, logs: Dict[str, str],
                 device=None) -> KernelReport:
    """Every contract of ``e`` at one audit shape, on the card: the launch
    plan from the wrappers' planners (K1/K2's resident limit from their
    own occupancy query), each instance's runtime numbers and ptxas lines,
    the host's coverage checks and the card's grid invariance. ``logs``:
    nvcc's output by source (``_build.build().logs``)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _rows

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    bf16 = shape.get("dtype") == "bf16"
    plan = launches(e, shape, lambda index: _rows.max_blocks(
        e.source, dev, bf16, {0: 1, 1: 2, 2: 4}[index % 3]))
    ptxas = parse_ptxas(logs.get(e.source, ""))
    resources = []
    with torch.cuda.device(dev):
        for ln in plan:
            attrs, mangled = query_instance(e.source, ln)
            resources.append(InstanceResources(e.name, ln, mangled, attrs, ptxas.get(mangled),
                                               declared_min_blocks(ln.label.split("<")[0])))
    origin = next(a.origin for a in e.shapes if a.name == shape_name)
    return KernelReport(e.name, shape_name, origin, resources,
                        [resource_contract(r) for r in resources],
                        state_contract(e, shape_name, shape, plan,
                                       grid_invariance(e, shape, dev)))


def audit_all(registry=REGISTRY, device=None) -> List[KernelReport]:
    """Every entry at every one of its audit shapes, on the card (the
    kernels are built first; their ptxas lines come from the build)."""
    from repro_torch.kernels import _build

    logs = _build.build().logs
    return [audit_kernel(e, a.name, a.shape, logs, device)
            for e in registry for a in e.shapes]


def registry_coverage(registry=REGISTRY, csrc: Optional[Path] = None,
                      signatures: Optional[Dict] = None) -> List[str]:
    """Every ``__global__`` function of ``csrc/*.cu`` and every symbol of
    ``_build.SIGNATURES`` must belong to a registry entry."""
    from repro_torch.kernels import _build

    csrc = csrc or _build.CSRC
    signatures = _build.SIGNATURES if signatures is None else signatures
    globals_ = set()
    for path in sorted(csrc.glob("*.cu")):
        globals_ |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                                   r"(\w+)\s*\(", path.read_text()))
    have_g = {g for e in registry for g in e.globals}
    have_s = {x for e in registry for x in e.symbols}
    f = [f"[coverage] __global__ {g} of csrc/ has no audit registry entry "
         "(repro_torch.kernels.introspect.REGISTRY)" for g in sorted(globals_ - have_g)]
    f += [f"[coverage] symbol {x} of {src}.so has no audit registry entry"
          for src, syms in sorted(signatures.items()) for x in sorted(syms) if x not in have_s]
    return f


#: the breakers ``--plant`` can plant, each into what an audit measured
PLANTS = ("cluster", "grid", "spill", "coverage")


def planted_failures(reports: Sequence[KernelReport], kind: str,
                     registry=REGISTRY) -> List[str]:
    """The failures one planted breaker draws: ``cluster``, every cluster
    launch at a cluster of 16; ``grid``, every cooperative grid one block
    above what can be resident; ``spill``, every instance with 4 B of
    spills in its ptxas record; ``coverage``, the registry without K4."""
    if kind == "coverage":
        return registry_coverage(tuple(e for e in registry if e.name != "flash_decode"))
    out: List[str] = []
    for r in reports:
        for res in r.resources:
            ln, a = res.launch, res.attrs
            if kind == "cluster" and ln.cluster > 1:
                res = dataclasses.replace(res, launch=dataclasses.replace(ln, cluster=16))
            elif kind == "grid" and ln.cooperative:
                res = dataclasses.replace(res, launch=dataclasses.replace(
                    ln, cooperative=a["blocks_per_sm"] * a["sms"] + 1))
            elif kind == "spill" and res.ptxas is not None:
                res = dataclasses.replace(res, ptxas=dataclasses.replace(
                    res.ptxas, spill_stores=4, spill_loads=4))
            else:
                continue
            out += resource_contract(res).failures
    return out


def print_reports(reports: Sequence[KernelReport], coverage: Sequence[str],
                  out=sys.stdout) -> None:
    """One line per (kernel, shape) and one per launched instance."""
    for r in reports:
        err = r.state.grid_error
        print(f"  {'OK' if r.ok else 'FAIL':4s} {r.name} at {r.shape} ({r.origin}): "
              f"{r.state.detail}; grid-invariance error "
              f"{'not measured' if err is None else f'{err:.3g}'}", file=out)
        for res in r.resources:
            a, p, ln = res.attrs, res.ptxas, res.launch
            spill = f"{p.spill_stores}/{p.spill_loads} B" if p else "no ptxas record"
            print(f"      {ln.label}: {a['regs']} registers, spills {spill}, smem "
                  f"{a['static_smem']} + {a['dyn_smem']} B, {a['threads']} threads, "
                  f"{a['blocks_per_sm']} blocks/SM (declared >= {res.min_blocks}), grid "
                  f"{ln.grid}" + (f", cooperative {ln.cooperative} of "
                                  f"{a['blocks_per_sm'] * a['sms']}" if ln.cooperative else "")
                  + (f", cluster {ln.cluster} ({a['clusters']} resident)"
                     if ln.cluster > 1 else ""), file=out)
        for msg in r.failures:
            print(f"    {msg}", file=out)
    for msg in coverage:
        print(f"    {msg}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="launch-resource, cross-block state and cost contracts over the "
                    "port's Hopper kernels (on the card)")
    ap.add_argument("--json", default=None, help="write the audit report to this path")
    ap.add_argument("--plant", choices=PLANTS, default=None,
                    help="plant one breaker into what the audit measured")
    args = ap.parse_args(argv)

    reports = audit_all()
    coverage = registry_coverage()
    planted = planted_failures(reports, args.plant) if args.plant else []
    ok = all(r.ok for r in reports) and not coverage and not planted
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"ok": ok, "coverage_failures": coverage, "plant": args.plant,
             "planted_failures": planted, "kernels": [r.to_dict() for r in reports]},
            indent=2, sort_keys=True))
    print_reports(reports, coverage)
    for msg in planted:
        print(f"    planted {args.plant}: {msg}", file=sys.stderr)
    if not ok:
        bad = sorted({r.name for r in reports if not r.ok}
                     | ({"coverage"} if coverage else set())
                     | ({f"planted {args.plant}"} if planted else set()))
        print(f"kernel_audit: contracts FAILED ({', '.join(bad)})", file=sys.stderr)
        return 1
    print(f"kernel_audit: all {len(reports)} (kernel, shape) contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
