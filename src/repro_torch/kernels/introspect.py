"""Audit registry: every Hopper kernel of the port, its launch plan and what
it claims about state that crosses blocks.

The port's counterpart of ``repro/kernels/introspect.py``. The reference's
entries capture a ``pallas_call`` and carry its VMEM guard; a Hopper kernel
has no trace to capture, so an entry here names what the auditor
(``repro_torch.analysis.kernel_audit``) reads elsewhere:

- its ``__global__`` functions (``csrc/<source>.cu``) and its ``extern "C"``
  symbols (``kernels/_build.py::SIGNATURES``), which ``registry_coverage``
  holds against the sources, so a new kernel cannot ship unaudited;
- ``instances(shape)``: the template instances a call at ``shape`` launches,
  each as the source's ``<source>_instance`` index and argument
  (``csrc/introspect.cuh``), with the grid the launcher gives it, from the
  wrappers' own planners (``_rows.union_plan``/``scatter_plan`` and
  ``max_blocks``, ``flash_decode.split_plan``,
  ``flash_attention.bwd_cluster``);
- ``crosses`` and ``deterministic``: what passes between blocks, as the
  kernel does it, and whether the result may depend on the grid;
- its audit shapes: the reference's own (``src/repro/kernels/
  introspect.py:69``, ``:103``, ``:135``, ``:168``) and the main paths'
  (``PERF.md`` §6).

Everything here is plain arithmetic: only ``max_blocks``, which the
instances of K1 and K2 take as an argument, needs the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from repro_torch.common.hw import HW
from repro_torch.kernels import _rows
from repro_torch.kernels.flash_attention import bwd_cluster
from repro_torch.kernels.flash_decode import split_plan

#: head dims every attention source is compiled for, in instance order
HEAD_DIMS = (16, 32, 64, 128)


@dataclass(frozen=True)
class Launch:
    """One kernel instance as a call launches it.

    ``index``/``arg``: the source's ``<source>_instance(index, arg)``
    query; ``grid``: the launcher's grid ``(x, y, z)``; ``cooperative``: the
    blocks of a cooperative launch (all resident at once), else 0;
    ``cluster``: the thread-block cluster (1: none) and ``groups`` the
    GQA group it must divide.
    """

    label: str
    index: int
    arg: int = 0
    grid: Tuple[int, int, int] = (1, 1, 1)
    cooperative: int = 0
    cluster: int = 1
    groups: int = 1


@dataclass(frozen=True)
class AuditShape:
    """One shape an entry is audited at, and where it comes from."""

    name: str
    shape: Dict
    origin: str


@dataclass(frozen=True)
class KernelEntry:
    """One Hopper kernel: where it lives, how a call launches it, what it
    claims."""

    name: str
    source: str                    # csrc/<source>.cu and its library
    replaces: str
    globals: Tuple[str, ...]       # __global__ functions
    symbols: Tuple[str, ...]       # extern "C" symbols (SIGNATURES)
    crosses: str
    deterministic: bool
    shapes: Tuple[AuditShape, ...]
    #: (shape, max_blocks) -> the launches of one call; max_blocks(instance
    #: index) gives a cooperative kernel's resident-block limit
    instances: Callable = field(repr=False)


def _hd_index(hd: int) -> int:
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return HEAD_DIMS.index(hd)


def _vec(d: int) -> int:
    """``_rows.vector_width`` for rows on a 16-byte boundary (the audit's)."""
    return _rows.vector_width(d, 0, 4)


# -- K1 and K2 ----------------------------------------------------------------


def _rows_index(bf16: bool, vec: int) -> int:
    """Instance index of K1 and K2 (``<source>_instance``): f32 rows at vec
    1, 2, 4, then bf16 rows."""
    return 3 * int(bf16) + {1: 0, 2: 1, 4: 2}[vec]


def _rows_label(kernel: str, bf16: bool, vec: int) -> str:
    return f"{kernel}<{'__nv_bfloat16' if bf16 else 'float'}, {vec}>"


def _union_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    bf16, vec = s["dtype"] == "bf16", _vec(s["D"])
    index = _rows_index(bf16, vec)
    plan = _rows.union_plan(s["T"], s["D"], s["V"], s["cap"], vec, max_blocks(index))
    return (Launch(_rows_label("union_segsum_kernel", bf16, vec), index,
                   grid=(plan.blocks, 1, 1), cooperative=plan.blocks),)


def _scatter_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    bf16, vec = s["dtype"] == "bf16", _vec(s["D"])
    index = _rows_index(bf16, vec)
    plan = _rows.scatter_plan(s["T"], s["D"], s["V"], vec, max_blocks(index))
    return (Launch(_rows_label("rowsparse_scatter_kernel", bf16, vec), index,
                   grid=(plan.blocks, 1, 1), cooperative=plan.blocks),)


# -- K3 -------------------------------------------------------------------------


def _attention_bf16_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    n_m = -(-s["Sq"] // 128)
    items = n_m * s["B"] * s["H"]
    return (Launch(f"attention_kernel<{s['hd']}>", _hd_index(s["hd"]),
                   grid=(min(items, HW["sms"]), 1, 1)),)


def _attention_f32_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    """One block of 4 warps per (64 query rows, head, batch) in a 1-D grid,
    the query tiles numbered from the last (the longest causal walks first)."""
    return (Launch(f"attention_kernel_f32<{s['hd']}>", 4 + _hd_index(s["hd"]),
                   grid=(-(-s["Sq"] // 64) * s["H"] * s["B"], 1, 1)),)


def _attention_bwd_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    p = "Bf16" if s["dtype"] == "bf16" else "Tf32x3"
    base = 8 * int(s["dtype"] == "bf16") + 2 * _hd_index(s["hd"])
    cluster = bwd_cluster(s["H"], s["KV"])
    groups = s["H"] // s["KV"]
    return (Launch(f"dq_kernel<{s['hd']}, {p}>", base, arg=1,
                   grid=(-(-s["Sq"] // 64), s["H"], s["B"])),
            Launch(f"dkv_kernel<{s['hd']}, {p}>", base + 1, arg=cluster,
                   grid=(-(-s["Sk"] // 64) * cluster, s["KV"], s["B"]), cluster=cluster,
                   groups=groups))


# -- K4 -------------------------------------------------------------------------


def _decode_instances(s: Dict, max_blocks: Callable) -> Tuple[Launch, ...]:
    """The split pass and the merge; ``lse`` in the shape: the merge's
    log-sum-exp instance (``return_lse``, a rank's slice of the cache)."""
    bf16 = s["dtype"] == "bf16"
    groups = s["H"] // s["KV"]
    nsplit, chunk = s.get("split") or split_plan(s["B"], s["KV"], groups, s["S"])
    i = _hd_index(s["hd"])
    t = "__nv_bfloat16" if bf16 else "float"
    split = f"split_kernel_tc<{s['hd']}>" if bf16 else f"split_kernel<float, {s['hd']}>"
    if s.get("lse"):
        merge = Launch(f"merge_kernel<{t}, {s['hd']}, true>", 16 + 4 * int(bf16) + i,
                       arg=chunk, grid=(s["B"] * s["H"], 1, 1))
    else:
        merge = Launch(f"merge_kernel<{t}, {s['hd']}>", 8 + 4 * int(bf16) + i, arg=chunk,
                       grid=(s["B"] * s["H"], 1, 1))
    return (Launch(split, 4 * int(bf16) + i, arg=chunk,
                   grid=(nsplit, s["KV"] * -(-groups // 8), s["B"])), merge)


#: PERF.md §6's main-path shapes, and the reference's audit shapes
_K1_REF = dict(V=65536, T=16 * 656, D=64, cap=8192, dtype="f32")
_K2_REF = dict(V=65536, T=8192, D=64, dtype="f32")
_LR = dict(V=37069, T=12800, D=1, cap=12800, dtype="f32")
_HEAVY = dict(V=1 << 22, T=512000, D=18, cap=512000)

REGISTRY = (
    KernelEntry(
        "union_segsum", "union_segsum", "src/repro/kernels/union_segsum.py:170",
        ("union_segsum_kernel",),
        ("union_segsum_launch", "union_segsum_max_blocks", "union_segsum_instance"),
        "grid-wide barriers of one cooperative launch, and f32 atomic adds into the "
        "union's rows: their order, so the rows' last bits, vary between runs",
        False,
        (AuditShape("reference", _K1_REF, "src/repro/kernels/introspect.py:69"),
         AuditShape("LR round", _LR, "PERF.md §6, [4]"),
         AuditShape("DIN round", dict(V=63001, T=12800, D=18, cap=12800, dtype="f32"),
                    "PERF.md §6, [15]"),
         AuditShape("LSTM round", dict(V=20000, T=25600, D=25, cap=20000, dtype="f32"),
                    "PERF.md §6, [16]"),
         AuditShape("heavy f32", dict(_HEAVY, dtype="f32"), "PERF.md §6, [6]"),
         AuditShape("heavy bf16", dict(_HEAVY, dtype="bf16"), "PERF.md §6, [6]")),
        _union_instances),
    KernelEntry(
        "rowsparse_scatter", "rowsparse_scatter", "src/repro/kernels/heat_scatter.py:138",
        ("rowsparse_scatter_kernel",),
        ("rowsparse_scatter_launch", "rowsparse_scatter_max_blocks",
         "rowsparse_scatter_instance"),
        "a grid-wide barrier between the zero fill and the scatter of one cooperative "
        "launch, and f32 atomic adds into the table: their order varies between runs",
        False,
        (AuditShape("reference", _K2_REF, "src/repro/kernels/introspect.py:103"),
         AuditShape("LR round", dict(V=37069, T=12800, D=1, dtype="f32"), "PERF.md §6, [3]"),
         AuditShape("heavy f32", dict(V=1 << 22, T=512000, D=18, dtype="f32"),
                    "PERF.md §6, [6]")),
        _scatter_instances),
    KernelEntry(
        "flash_attention_bf16", "flash_attention", "src/repro/kernels/flash_attention.py:100",
        ("attention_kernel",), ("flash_attention_bf16_launch", "flash_attention_instance"),
        "nothing: a persistent block owns each (query tile, head, batch) it takes whole",
        True,
        (AuditShape("Qwen2.5-14B prefill",
                    dict(B=4, Sq=1024, Sk=1024, H=40, KV=8, hd=128, causal=True), "PERF.md §6, [12]"),
         AuditShape("Whisper encoder",
                    dict(B=4, Sq=1500, Sk=1500, H=20, KV=20, hd=64, causal=False),
                    "PERF.md §6, [54]"),
         AuditShape("Whisper encoder prefill, rank of (1, 4)",
                    dict(B=2, Sq=1500, Sk=1500, H=5, KV=5, hd=64, causal=False),
                    "PERF.md §6, [73]"),
         AuditShape("Zamba2 prefill, rank of (1, 2)",
                    dict(B=2, Sq=128, Sk=128, H=16, KV=16, hd=64, causal=True),
                    "PERF.md §6, [73]")),
        _attention_bf16_instances),
    KernelEntry(
        "flash_attention_f32", "flash_attention", "src/repro/kernels/flash_attention.py:100",
        ("attention_kernel_f32",), ("flash_attention_f32_launch",),
        "nothing: a block owns its 64 query rows of one head and streams their key "
        "tiles through its own cp.async ring",
        True,
        (AuditShape("reference",
                    dict(B=1, Sq=2048, Sk=2048, H=4, KV=2, hd=128, causal=True),
                    "src/repro/kernels/introspect.py:135"),
         AuditShape("training shape",
                    dict(B=16, Sq=128, Sk=128, H=40, KV=8, hd=128, causal=True),
                    "PERF.md §6, [38]"),
         AuditShape("Whisper encoder training, rank of (1, 2)",
                    dict(B=4, Sq=1500, Sk=1500, H=10, KV=10, hd=64, causal=False),
                    "PERF.md §6, [73]"),
         AuditShape("Zamba2 shared attention training, rank of (2, 2)",
                    dict(B=2, Sq=128, Sk=128, H=16, KV=16, hd=64, causal=True),
                    "PERF.md §6, [73]")),
        _attention_f32_instances),
    KernelEntry(
        "flash_attention_bwd", "flash_attention_bwd",
        "no pallas_call: autodiff of src/repro/models/layers.py:154",
        ("dq_kernel", "dkv_kernel"),
        ("flash_attention_bwd_f32_launch", "flash_attention_bwd_bf16_launch",
         "flash_attention_bwd_instance"),
        "dQ's D and 1 / sum P handed from the first kernel to the second through "
        "memory; dK/dV partials summed over a thread-block cluster in rank order",
        True,
        (AuditShape("training shape",
                    dict(B=16, Sq=128, Sk=128, H=40, KV=8, hd=128, causal=True, dtype="f32"),
                    "PERF.md §6, [38]"),
         AuditShape("Whisper encoder training",
                    dict(B=8, Sq=1500, Sk=1500, H=20, KV=20, hd=64, causal=False, dtype="f32"),
                    "PERF.md §6, [54]"),
         AuditShape("Whisper encoder training, rank of (1, 2)",
                    dict(B=4, Sq=1500, Sk=1500, H=10, KV=10, hd=64, causal=False, dtype="f32"),
                    "PERF.md §6, [73]"),
         AuditShape("Zamba2 shared attention training, rank of (2, 2)",
                    dict(B=2, Sq=128, Sk=128, H=16, KV=16, hd=64, causal=True, dtype="f32"),
                    "PERF.md §6, [73]")),
        _attention_bwd_instances),
    KernelEntry(
        "flash_decode", "flash_decode", "src/repro/kernels/flash_decode.py:88",
        ("split_kernel", "split_kernel_tc", "merge_kernel"),
        ("flash_decode_launch", "flash_decode_instance"),
        "the split pass writes each cache slice's (max, sum, acc) as f32 partials; "
        "the merge combines them by log-sum-exp in slice order (its log-sum-exp "
        "instance writes f32 o and the rows' log-sum-exp for the merge across ranks)",
        True,
        (AuditShape("reference", dict(B=2, H=4, KV=2, S=4096, hd=128, dtype="f32"),
                    "src/repro/kernels/introspect.py:168"),
         AuditShape("Qwen2.5-14B step", dict(B=4, H=40, KV=8, S=1056, hd=128, dtype="bf16"),
                    "PERF.md §6, [12]"),
         AuditShape("Whisper cross step", dict(B=4, H=20, KV=20, S=1500, hd=64, dtype="bf16"),
                    "PERF.md §6, [54]"),
         AuditShape("Qwen2.5-14B rank slice, m = 2",
                    dict(B=4, H=40, KV=8, S=2064, hd=128, dtype="bf16", lse=True),
                    "PERF.md §6, [69]"),
         AuditShape("Qwen2.5-14B rank slice, m = 4",
                    dict(B=4, H=40, KV=8, S=1032, hd=128, dtype="bf16", lse=True),
                    "PERF.md §6, [69]"),
         AuditShape("Whisper cross rank slice, m = 2",
                    dict(B=2, H=20, KV=20, S=750, hd=64, dtype="bf16", lse=True),
                    "PERF.md §6, [73]"),
         AuditShape("Zamba2 rank slice, m = 2",
                    dict(B=2, H=32, KV=32, S=66, hd=64, dtype="bf16", lse=True),
                    "PERF.md §6, [73]")),
        _decode_instances),
)

def entry(name: str, registry=REGISTRY) -> KernelEntry:
    for e in registry:
        if e.name == name:
            return e
    raise KeyError(name)


def launches(e: KernelEntry, shape: Dict,
             max_blocks: Optional[Callable] = None) -> Tuple[Launch, ...]:
    """The launches of one call of ``e`` at ``shape``; ``max_blocks(index)``
    (cooperative kernels only) defaults to two 512-thread blocks on each of
    the H100's SMs, the occupancy the sources declare."""
    return e.instances(shape, max_blocks or (lambda index: 2 * HW["sms"]))
