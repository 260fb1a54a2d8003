"""Launch plans of K1 (``union_segsum``) and K2 (``rowsparse_scatter``).

Both are one cooperative launch of ``THREADS``-thread blocks
(``csrc/rowsum.cuh``) in which a team of threads serves each row of
``rows``, moving ``vec`` f32 elements per load and per atomic add. The grid
is sized to the work and capped at the blocks that fit on the card at once,
which the kernel's own occupancy query gives (a cooperative launch of more
is refused, and the wrapper raises). Everything here but ``max_blocks`` is
plain arithmetic, so the CPU tests hold it at the shapes the card runs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

THREADS = 512   # kThreads in csrc/rowsum.cuh


def vector_width(d: int, rows_ptr: int, esize: int) -> int:
    """Row elements per load and per atomic add: 4 or 2 where the width ``d``
    and the rows' address (``esize`` bytes an element) allow it, else 1.
    Outputs are allocated by the wrappers, so only the rows can be
    misaligned."""
    for vec in (4, 2):
        if d % vec == 0 and rows_ptr % (vec * esize) == 0:
            return vec
    return 1


def team_size(d: int, vec: int) -> int:
    """Threads per row: the ``d / vec`` lanes a row needs, rounded up to a
    power of two and capped at a warp (wider rows loop)."""
    lanes = max(d // vec, 1)
    return min(32, 1 << (lanes - 1).bit_length())


@dataclass(frozen=True)
class RowPlan:
    """One launch: elements per vector, threads per row, blocks, and the
    32-bit words of K1's bit-packed union (0 for K2)."""

    vec: int
    team: int
    blocks: int
    words: int = 0

    @property
    def scratch_ints(self) -> int:
        """K1's scratch: (bits, rank offset) per word, one count per block."""
        return 2 * self.words + self.blocks

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.scratch_ints


def _blocks(units: int, max_blocks: int) -> int:
    return max(1, min(max_blocks, -(-units // THREADS)))


@functools.lru_cache(maxsize=256)
def union_plan(t: int, d: int, num_rows: int, cap: int, vec: int,
               max_blocks: int) -> RowPlan:
    """K1: one thread per (row, lane), per union word, or per 4 output
    floats, whichever is most, up to ``max_blocks``. Cached: a trainer asks
    for the same plan every round."""
    team = team_size(d, vec)
    words = -(-num_rows // 32)
    return RowPlan(vec, team, _blocks(max(t * team, words, cap * d // 4), max_blocks),
                   words)


@functools.lru_cache(maxsize=256)
def scatter_plan(t: int, d: int, num_rows: int, vec: int, max_blocks: int) -> RowPlan:
    """K2: one thread per (row, lane) or per 4 floats of the dense output,
    whichever is more, up to ``max_blocks``."""
    team = team_size(d, vec)
    return RowPlan(vec, team, _blocks(max(t * team, num_rows * d // 4), max_blocks))


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, for a launcher (the call
    Triton's launcher makes: ``torch.cuda.current_stream`` builds a Stream
    object, which costs more host time than the launch itself)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_max_blocks: Dict[Tuple, int] = {}


def max_blocks(name: str, device: torch.device, rows_bf16: bool, vec: int) -> int:
    """Blocks of ``csrc/<name>.cu``'s kernel instance that fit on ``device``
    at once (its ``<name>_max_blocks`` query), asked once per instance."""
    key = (name, device.index, rows_bf16, vec)
    n = _max_blocks.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _build.launcher(name, f"{name}_max_blocks")(int(rows_bf16), vec)
        if n <= 0:
            raise RuntimeError(f"{name}: occupancy query failed with CUDA error {-n}")
        _max_blocks[key] = n
    return n
