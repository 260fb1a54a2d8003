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

A :class:`DeviceMesh` is the 2-D (or, under ``multi_pod``, 3-D) mesh of the
reference's launchers: axes ``("data", "model")`` (``("pod", "data",
"model")``), one process group per row and per column, each axis a
:class:`CohortMesh` (``mesh.axis("data")``) that ``CohortSharding`` and the
model-axis collectives of ``repro_torch.sharding.parallel`` take. A 3-D
mesh also joins ``pod`` and ``data`` into one axis, the multi-pod rules'
batch axis (``mesh.axis(("pod", "data"))``, its ranks row-major over the
two). ``make_host_mesh`` lays it over the ranks of the process group,
``make_production_mesh`` at the reference's 16x16 and 2x16x16.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def shard_body(fn: Callable) -> Callable:
    """Mark ``fn`` as a shard body and return it unchanged.

    A shard body runs on every rank with the rank's shard of the cohort,
    the port's counterpart of a function wrapped in ``shard_map``: a
    reduction in it covers the rank's shard only unless a collective
    combines it. ``repro_torch.analysis.lint`` roots its shard rules at the
    functions decorated with this (or passed to it).
    """
    return fn


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

    def pmax(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks (counted as an all-reduce)."""
        buf = x.contiguous().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        self._count(tag, "all-reduce", buf)
        return buf

    def all_gather(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` stacked rank-major: ``(size,) + x.shape``."""
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=self.group)
        self._count(tag, "all-gather", out)
        return out

    def reduce_scatter(self, x: torch.Tensor, tag: str, dim: int = 0) -> torch.Tensor:
        """This rank's slice on ``dim`` of the sum of every rank's ``x``
        (``x.shape[dim]`` a multiple of ``size``; counted as its whole
        input, as an all-gather counts its whole output)."""
        width = x.shape[dim] // self.size
        buf = x.movedim(dim, 0).contiguous()
        out = torch.empty((width,) + tuple(buf.shape[1:]), dtype=x.dtype, device=x.device)
        # reduce_scatter_single is reduce_scatter_tensor's newer name
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, buf, group=self.group)
        self._count(tag, "reduce-scatter", buf)
        return out.movedim(0, dim)

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
    device = _join("make_cohort_mesh", device, backend, init_method, rank, world_size)
    return CohortMesh(rank=dist.get_rank(), size=dist.get_world_size(), device=device,
                      axis=axis)


def _join(caller: str, device, backend: Optional[str], init_method: Optional[str],
          rank: Optional[int], world_size: Optional[int]) -> torch.device:
    """Resolve the rank's device and join (or start) the default process
    group, as ``make_cohort_mesh`` documents."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{caller} runs on CUDA by default and no CUDA device is "
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
    return device


def axis_key(names) -> str:
    """The name of an axis, or of the joint axis of several (``"pod+data"``),
    as ``DeviceMesh.axes`` and its counters key them."""
    return names if isinstance(names, str) else "+".join(names)


#: the joint axes a mesh makes where it has their axes: the multi-pod
#: rules' batch axis (``sharding.rules.make_rules(multi_pod=True)``)
JOINT_AXES = (("pod", "data"),)
#: the launchers' axis names by the mesh's number of axes
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclass(eq=False)
class DeviceMesh:
    """A mesh of ranks with named axes, laid out row-major (the last axis
    fastest, as ``jax.make_mesh`` lays out devices): the rank at coordinates
    ``(d, m)`` of a ``(D, M)`` mesh is ``ranks[d * M + m]``.

    ``axis(name)`` is the :class:`CohortMesh` over the ranks that differ
    from this one on that axis alone, with this rank's coordinate as its
    rank; ``axis(("pod", "data"))`` the joint axis's (``JOINT_AXES``), its
    rank row-major over the two. ``shape`` and ``axis_names`` read as a JAX
    mesh's do. ``counters`` are each axis's, keyed by axis name (a joint
    axis's by ``axis_key``: ``"pod+data"``).
    """

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device
    axes: Dict[str, CohortMesh] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on each axis."""
        flat, out = self.ranks.index(self.rank), []
        for n in reversed(self.sizes):
            out.append(flat % n)
            flat //= n
        return tuple(reversed(out))

    def axis(self, name) -> CohortMesh:
        """The axis ``name``, or the joint axis of a tuple of names (a
        tuple of one is that axis)."""
        key = axis_key(name)
        if key not in self.axes:
            raise ValueError(f"mesh axes are {tuple(self.axes)}, not {name!r}")
        return self.axes[key]

    @property
    def counters(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        return {name: dict(m.counters) for name, m in self.axes.items()}

    def reset_counters(self) -> None:
        for m in self.axes.values():
            m.reset_counters()

    def destroy(self) -> None:
        """Tear the process group down (the mesh is unusable afterwards)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_device_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("data", "model"), *,
                     device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> DeviceMesh:
    """Join the process group (as ``make_cohort_mesh``) and return this
    rank's :class:`DeviceMesh` of ``shape``. The world is cut into
    consecutive blocks of ``prod(shape)`` ranks, each a mesh of its own
    (sub-meshes of one world: a 4-rank world holds two ``(1, 2)`` meshes);
    it must be a whole number of them. Besides each axis's groups, the
    mesh makes one group per line of each of ``JOINT_AXES`` whose axes it
    has. Every rank makes every block's groups, in one order, as
    ``dist.new_group`` asks."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
    device = _join("make_device_mesh", device, backend, init_method, rank, world_size)
    world, me = dist.get_world_size(), dist.get_rank()
    per = math.prod(shape)
    if world % per:
        raise ValueError(f"a world of {world} ranks is not a whole number of "
                         f"{shape} meshes")
    mine = None
    for base in range(0, world, per):
        grid = torch.arange(base, base + per).reshape(shape)
        axes = {}
        joints = [j for j in JOINT_AXES if all(n in axis_names for n in j)]
        for names in [(n,) for n in axis_names] + joints:
            dims = [axis_names.index(n) for n in names]
            size = math.prod(shape[i] for i in dims)
            # each line's ranks row-major over ``names``
            lines = grid.movedim(dims, list(range(-len(dims), 0))).reshape(-1, size).tolist()
            for line in lines:
                group = dist.new_group(line)
                if me in line:
                    key = axis_key(names)
                    axes[key] = CohortMesh(rank=line.index(me), size=len(line),
                                           device=device, group=group, axis=key)
        if base <= me < base + per:
            mine = DeviceMesh(axis_names, shape, tuple(range(base, base + per)), me,
                              device, axes)
    return mine


def make_host_mesh(model_parallel: int = 1, **kw) -> DeviceMesh:
    """A ``(world / model_parallel, model_parallel)`` mesh of axes
    ``("data", "model")`` over the process group's ranks (``kw`` as
    ``make_device_mesh``: the card and torchrun's environment by default)."""
    world = kw.get("world_size")
    if world is None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else _env_int("WORLD_SIZE", None))
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the "
                         f"{world} ranks")
    return make_device_mesh((world // model_parallel, model_parallel), **kw)


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's production mesh: (16, 16) over ``("data", "model")``,
    or (2, 16, 16) over ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, **kw) -> DeviceMesh:
    """The reference's production mesh over a world of exactly its size
    (256 or 512 ranks); raises unless ``WORLD_SIZE`` (or ``world_size``)
    is that product."""
    shape, names = production_mesh_shape(multi_pod)
    world = kw.get("world_size")
    if world is None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "0")))
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return make_device_mesh(shape, names, **kw)


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
