"""Cohort meshes over ``torch.distributed``: one process per rank.

The JAX package drives every device of a cohort mesh from one process with
``shard_map``. The port runs the same round as SPMD: every rank builds the
same trainer from the same seed, samples the same cohort from the same numpy
stream, holds the replicated server state, and takes its own shard-major
block of clients out of the full cohort. The collectives of a
:class:`CohortMesh` stand in for ``psum``, ``pmean`` and ``all_gather``
along the mesh axis.

    torchrun --nproc_per_node=8 train.py     # make_cohort_mesh() in train.py

``make_cohort_mesh`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and
``MASTER_ADDR``/``MASTER_PORT`` through ``init_method="env://"``) as
``torchrun`` sets them, or takes ``init_method``, ``rank`` and
``world_size``. The card is the default (``cuda:LOCAL_RANK``, NCCL) and a
mesh without one raises; ``device="cpu"`` selects gloo. ``backend="gloo"``
with CUDA tensors lets several ranks share one card (NCCL refuses two ranks
on one device). ``spawn_ranks`` starts ranks on one host with a bounded
join, for the tests and for hosts with one card.

Every collective adds its kind and payload bytes (an all-gather's whole
output) to ``counters`` under the caller's tag, the component names of
``repro_torch.federated.plan.round_collective_budget``; a sharded round step
resets them when it starts.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(eq=False)
class CohortMesh:
    """A 1-D mesh of ``size`` ranks over one process group.

    ``axis_names`` and ``shape`` read as a JAX mesh's do, so
    ``CohortSharding`` validates the same way. Each collective takes and
    returns tensors on the rank's device (gloo takes CUDA tensors too).
    """

    rank: int
    size: int
    device: torch.device
    group: Any = None               # None: the default process group
    axis: str = "data"
    counters: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def reset_counters(self) -> None:
        self.counters = {}

    def by_op(self) -> Dict[str, float]:
        """Counted bytes summed by collective kind."""
        out: Dict[str, float] = {}
        for c in self.counters.values():
            out[c["op"]] = out.get(c["op"], 0.0) + c["bytes"]
        return out

    def _count(self, tag: str, op: str, t: torch.Tensor) -> None:
        c = self.counters.setdefault(tag, {"op": op, "bytes": 0.0})
        if c["op"] != op:
            raise ValueError(f"collective tag {tag!r} counted as {c['op']} and {op}")
        c["bytes"] += float(t.numel() * t.element_size())

    def psum(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks (an all-reduce; ``x`` is not written)."""
        buf = x.contiguous().clone()
        dist.all_reduce(buf, group=self.group)
        self._count(tag, "all-reduce", buf)
        return buf

    def pmean(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Mean of ``x`` over the ranks."""
        return self.psum(x, tag) / self.size

    def all_gather(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` stacked rank-major: ``(size,) + x.shape``."""
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=self.group)
        self._count(tag, "all-gather", out)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def destroy(self) -> None:
        """Tear the process group down (the mesh is unusable afterwards)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"make_cohort_mesh: pass {name.lower()} or set {name} "
                         "(torchrun sets it)")
    return int(os.environ[name])


def make_cohort_mesh(axis: str = "data", *, device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> CohortMesh:
    """Join (or start) the default process group and return this rank's mesh.

    ``device=None`` is ``cuda:LOCAL_RANK`` and raises without a card;
    ``device="cpu"`` defaults the backend to gloo, a CUDA device to NCCL.
    ``init_method`` defaults to ``"env://"``; ``rank`` and ``world_size``
    default to ``RANK`` and ``WORLD_SIZE``. A process group that is already
    initialised is joined as it is.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_cohort_mesh runs on CUDA by default and no CUDA device is "
                "available: pass device='cpu' for gloo ranks on the host")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=_env_int("RANK", rank), world_size=_env_int("WORLD_SIZE", world_size))
    return CohortMesh(rank=dist.get_rank(), size=dist.get_world_size(), device=device,
                      axis=axis)


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (),
                timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes and wait.

    A rank that raises fails the call (the others are terminated); ranks
    still running after ``timeout_s`` seconds (a rank stuck in a collective)
    are killed and the call raises ``TimeoutError``. ``fn`` must be
    importable by name: the processes start from a fresh interpreter.
    """
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=tuple(args), nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
