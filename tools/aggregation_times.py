#!/usr/bin/env python3
"""Time K1 (``union_segsum``) and K2 (``rowsparse_scatter``) on one CUDA card
at the trainer's shape and at an aggregation-heavy shape.

    python3 tools/aggregation_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in one call on
one card: unpack the other tree with ``git archive`` into a git-ignored
directory and run the script on it and on this tree in turns (other,
this, this, other). Each run prints the card's name and power limit and
one JSON line per case: kernel milliseconds by CUDA events, the wrapper in
the loop, and the launches per call.

``chip_smoke.py`` takes the cohort generator, the shapes and ``cuda_ms``
from here.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N_CLIENTS = 6040               # MovieLens-1M users: the heat total N
#: (V, K clients, R rows per client, D) of each timed shape. "trainer" is
#: the LR round's (37,069 features, 100 clients); "heavy" is synthetic and
#: bound by bytes: 2^22 table rows, DIN's width 18, 1,000 clients x 512 rows
SHAPES = {"trainer": (37_069, 100, 128, 1), "heavy": (1 << 22, 1000, 512, 18)}


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


def cohort(rng, k: int, r: int, v: int, d: int, dtype, device, all_pad: int = 0,
           out_of_range: float = 0.0, hot: int | None = None):
    """A cohort of per-client sorted unique ids (-1 padded) with hot ids
    shared across clients, its rows, and heat counts.

    Heat is consistent with the cohort, as a real n_m is: an id that c of
    the k sampled clients touch has heat about c * N / k (plus noise), so
    the correction ``N / n_m`` is large only on ids few rows sum into. (With
    heat unrelated to the cohort, a hot id could sum many rows that cancel
    and then be scaled by hundreds, and the f32 sum order that the atomics
    change would show far above the tolerance.) ``hot``, when given, is an
    id that every client holds: K rows add onto one address.
    """
    n_hot = max(v // 50, 16)
    ids = np.full((k, r), -1, np.int32)
    for i in range(all_pad, k):
        n = int(rng.integers(r // 2, r + 1))
        pick = np.concatenate([rng.integers(0, n_hot, n // 2),
                               rng.integers(0, v, n - n // 2)])
        u = np.unique(pick)
        if hot is not None and hot not in u:
            u = np.unique(np.concatenate([u[:r - 1], [hot]]))
        ids[i, :len(u)] = u
    touched = np.bincount(ids[ids >= 0], minlength=v)
    heat = (touched * (N_CLIENTS / k) + rng.integers(0, 60, v)).astype(np.float32)
    if out_of_range:
        hit = (ids >= 0) & (rng.random(ids.shape) < out_of_range)
        ids[hit] = v + rng.integers(0, 1000, int(hit.sum()))
    rows = rng.normal(size=(k, r, d)).astype(np.float32) * (ids >= 0)[..., None]
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(rows).to(device, dtype),
            torch.from_numpy(heat).to(device))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("aggregation_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.heat_scatter import rowsparse_scatter
    from repro_torch.kernels.union_segsum import union_segsum

    dev = torch.device("cuda")
    print(f"card: {card_line()}; src: {args.src}")
    for shape, (v, k, r, d) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ids, rows, heat = cohort(np.random.default_rng(0), k, r, v, d, dtype, dev)
            flat_ids, flat_rows = ids.reshape(-1), rows.reshape(k * r, d)
            cap = min(v, k * r)
            k1 = lambda: union_segsum(ids, rows, heat, float(N_CLIENTS), cap, v,  # noqa: E731
                                      scale=1.0 / k)
            k2 = lambda: rowsparse_scatter(flat_ids, flat_rows, heat,  # noqa: E731
                                           float(N_CLIENTS), v, scale=1.0 / k)
            union_segsum.launches = rowsparse_scatter.launches = 0
            k1(), k2()
            launches = (union_segsum.launches, rowsparse_scatter.launches)
            print(json.dumps({"src": args.src, "shape": shape, "dtype": str(dtype),
                              "V": v, "T": k * r, "D": d, "cap": cap,
                              "k1_ms": cuda_ms(k1), "k2_ms": cuda_ms(k2),
                              "launches_per_call": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
