#!/usr/bin/env python3
"""Where K1's and K2's device time goes, phase by phase, on one CUDA card.

    python3 tools/aggregation_phases.py [--shape heavy|trainer]

Builds copies of ``csrc/union_segsum.cu`` and ``csrc/rowsparse_scatter.cu``
that return after their k-th grid-wide barrier, and copies whose row phase
makes no atomic adds (the loads stay), under ``build/aggregation_phases/``,
then times each at the shape by CUDA events around launches made straight
through the launcher (no wrapper in the loop, so the device sets the time).
The differences between consecutive copies are the phases' times; the
copies compute nothing usable. Prints the card's name and power limit and
one line per copy.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch.kernels import _build, _rows  # noqa: E402
from tools.aggregation_times import N_CLIENTS, SHAPES, card_line, cohort, cuda_ms  # noqa: E402

OUT = ROOT / "build" / "aggregation_phases"
ATOMIC = "          add_row<VEC>(out + static_cast<int64_t>(dg[g]) * d + j, x[g]);"


def stop_after(k: int, src: str) -> str:
    """``src`` returning right after its k-th ``grid.sync()``."""
    count = iter(range(1, 100))
    return re.sub(r"grid\.sync\(\);",
                  lambda m: m.group(0) + (" return;" if next(count) == k else ""), src)


def variants() -> dict:
    k1 = (_build.CSRC / "union_segsum.cu").read_text()
    k2 = (_build.CSRC / "rowsparse_scatter.cu").read_text()
    header = (_build.CSRC / "rowsum.cuh").read_text()
    assert ATOMIC in header, "the row phase's atomic add moved: update ATOMIC"
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "rowsum_no_atomics.cuh").write_text(
        header.replace(ATOMIC, "          if (x[g][0] == 1234.5f) " + ATOMIC.lstrip()))
    no_atomics = lambda s: s.replace('"rowsum.cuh"', '"rowsum_no_atomics.cuh"')  # noqa: E731
    out = {("union_segsum", f"stop after barrier {k}"): stop_after(k, k1) for k in (1, 2, 3, 4)}
    out[("union_segsum", "whole")] = k1
    out[("union_segsum", "whole, no atomics")] = no_atomics(k1)
    out[("rowsparse_scatter", "stop after barrier 1")] = stop_after(1, k2)
    out[("rowsparse_scatter", "whole")] = k2
    out[("rowsparse_scatter", "whole, no atomics")] = no_atomics(k2)
    return out


def build(sources: dict) -> dict:
    """Compile every copy in parallel; its launcher and occupancy query."""
    procs = {}
    for i, ((name, tag), src) in enumerate(sources.items()):
        cu, so = OUT / f"{name}_{i}.cu", OUT / f"{name}_{i}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-I", str(OUT),
               "-o", str(so), str(cu)]
        procs[(name, tag)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, tag), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({tag}):\n{log}")
        lib = ctypes.CDLL(str(so))
        fns[(name, tag)] = {}
        for symbol, argtypes in _build.SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[(name, tag)][symbol] = fn
    return fns


def launch(name: str, fns: dict, ids, rows, heat, cap: int, v: int, scale: float):
    """A no-argument launch of one copy on preallocated outputs, planned as
    the wrappers plan it, and the outputs (to be kept alive while it runs)."""
    dev = ids.device
    t, d = ids.numel(), rows.numel() // ids.numel()
    bf16 = int(rows.dtype == torch.bfloat16)
    vec = _rows.vector_width(d, rows.data_ptr(), rows.element_size())
    blocks = fns[f"{name}_max_blocks"](bf16, vec)
    stream = _rows.raw_stream(dev)
    common = (ids.data_ptr(), rows.data_ptr(), bf16, heat.data_ptr(), float(N_CLIENTS), scale,
              t, d, v)
    if name == "union_segsum":
        plan = _rows.union_plan(t, d, v, cap, vec, blocks)
        out = torch.empty((cap, d), device=dev)
        buf = torch.empty(cap + cap % 2 + plan.scratch_ints, dtype=torch.int32, device=dev)
        args = common + (cap, plan.vec, plan.team, plan.blocks,
                         buf.data_ptr() + 4 * (cap + cap % 2), buf.data_ptr(), out.data_ptr(),
                         dev.index, stream)
    else:
        plan = _rows.scatter_plan(t, d, v, vec, blocks)
        out = torch.empty((v, d), device=dev)
        args = common + (plan.vec, plan.team, plan.blocks, out.data_ptr(), dev.index, stream)
    fn = fns[f"{name}_launch"]
    return (lambda: fn(*args)), (out, buf) if name == "union_segsum" else (out,)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="heavy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("aggregation_phases: no CUDA device", file=sys.stderr)
        return 1
    fns = build(variants())
    dev = torch.device("cuda", torch.cuda.current_device())
    v, k, r, d = SHAPES[args.shape]
    print(f"card: {card_line()}; shape {args.shape}: V={v} K={k} R={r} D={d}")
    for dtype in (torch.float32, torch.bfloat16):
        ids, rows, heat = cohort(np.random.default_rng(0), k, r, v, d, dtype, dev)
        for (name, tag), copy in fns.items():
            fn, _outputs = launch(name, copy, ids, rows, heat, min(v, k * r), v, 1.0 / k)
            _build.check(f"{name} ({tag})", fn())
            print(f"{str(dtype):15s} {name:18s} {tag:22s} {cuda_ms(fn, 100):.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
