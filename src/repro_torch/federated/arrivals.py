"""Deterministic client-arrival simulation for the buffered-async engine.

The paper's setting — millions of intermittently-available clients — is
exactly where stragglers dominate a barrier engine's wall clock. To study
FedSubAvg under asynchrony *reproducibly*, arrival timing is not sampled at
run time: :class:`ArrivalSim` draws every client's round-trip delay from a
seeded host RNG and **compiles the whole run into a static event stream**
(:class:`EventSchedule`) before anything touches a device. Each scheduled
client task contributes two events:

``DISPATCH``
    The server hands the client the *current* parameters; the client's local
    delta is computed against them and parked in a bounded in-flight slot.
``ARRIVAL``
    The delta reaches the server and joins the aggregation buffer; every
    ``buffer_size`` arrivals the buffer fires one staleness-weighted apply.

Because the event order is fixed host-side, everything timing-derived is
static: the server version at any event is ``arrivals_so_far //
buffer_size``, so each arrival's **staleness** (versions elapsed since its
dispatch), the **fire** flags, the greedy in-flight **slot** assignment and
the per-event in-flight count are all plain numpy columns of the schedule:
the engine's event loop branches on them on the host, with no device read.

This module is numpy only and keeps the JAX package's draw order, so equal
seeds give bit-identical schedules in both packages.

Delays are measured in dispatch-wave units (the server dispatches one
K-client wave per time unit). ``delay="zero"`` collapses the stream to the
synchronous order — K dispatches then K arrivals per wave — which is the
degenerate case the parity tests pin against ``run_rounds``. The modeled
makespans (:meth:`EventSchedule.barrier_makespan` /
:meth:`EventSchedule.async_makespan`) are seed-deterministic, so a regression check
can pin the async-vs-barrier simulated-throughput ratio.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

#: event kinds (the ``kind`` column of an EventSchedule)
DISPATCH = 0
ARRIVAL = 1

DELAY_DISTRIBUTIONS = ("zero", "exponential", "lognormal")


@dataclass(frozen=True)
class ArrivalSim:
    """Seeded arrival-process generator; ``compile`` produces the schedule.

    ``num_rounds`` dispatch waves of K clients each (K is supplied at
    compile time so one sim can schedule different cohort sizes).

    ``delay`` ∈ {"zero", "exponential", "lognormal"}: per-task round-trip
    delay in wave units. ``delay_scale`` is the exponential mean / lognormal
    median; ``lognormal_sigma`` sets the log-normal tail weight (σ ≳ 1 is
    genuinely heavy-tailed).

    Straggler injection: ``straggler_frac`` of tasks (drawn without
    replacement), plus any explicit ``straggler_tasks``, get their delay
    multiplied by ``straggler_factor``. Dropout injection: ``dropout_frac``
    of tasks, plus ``dropout_tasks``, never dispatch and never arrive —
    their updates simply do not exist, which under FedSubAvg must leave
    their private rows exactly untouched.

    Draw order is fixed (delays, then stragglers, then dropouts), so equal
    seeds give bit-identical schedules.
    """

    num_rounds: int
    delay: str = "zero"
    delay_scale: float = 0.5
    lognormal_sigma: float = 1.0
    straggler_frac: float = 0.0
    straggler_factor: float = 10.0
    dropout_frac: float = 0.0
    straggler_tasks: Tuple[int, ...] = ()
    dropout_tasks: Tuple[int, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if self.num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {self.num_rounds}")
        if self.delay not in DELAY_DISTRIBUTIONS:
            raise ValueError(f"unknown delay distribution {self.delay!r}: "
                             f"expected one of {DELAY_DISTRIBUTIONS}")
        if self.delay_scale <= 0.0:
            raise ValueError(f"delay_scale must be > 0, got {self.delay_scale}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError(f"straggler_frac out of [0, 1]: "
                             f"{self.straggler_frac}")
        if self.straggler_factor < 1.0:
            raise ValueError(f"straggler_factor must be >= 1, got "
                             f"{self.straggler_factor}")
        if not 0.0 <= self.dropout_frac <= 1.0:
            raise ValueError(f"dropout_frac out of [0, 1]: {self.dropout_frac}")

    # ------------------------------------------------------------------
    def compile(self, clients_per_round: int,
                buffer_size: int) -> "EventSchedule":
        """Draw delays and compile the padded event stream.

        Task ``t`` is client slot ``t % K`` of wave ``t // K`` — the same
        order ``FederatedTrainer`` samples cohorts in, so the trainer can
        stack all waves' data once and index it by the schedule's ``task``
        column. Events are ordered by ``(time, kind, task)``: dispatches
        precede arrivals at equal times, which is what makes the zero-delay
        stream reproduce the synchronous engine's per-wave order exactly.
        """
        k = int(clients_per_round)
        m = int(buffer_size)
        if k < 1:
            raise ValueError(f"clients_per_round must be >= 1, got {k}")
        if m < 1:
            raise ValueError(f"buffer_size must be >= 1, got {m}")
        num_tasks = self.num_rounds * k
        rng = np.random.default_rng(self.seed)

        if self.delay == "zero":
            delays = np.zeros(num_tasks)
        elif self.delay == "exponential":
            delays = rng.exponential(self.delay_scale, size=num_tasks)
        else:  # lognormal: median delay_scale, tail weight lognormal_sigma
            delays = rng.lognormal(mean=math.log(self.delay_scale),
                                   sigma=self.lognormal_sigma,
                                   size=num_tasks)

        stragglers = set(int(t) for t in self.straggler_tasks)
        n_strag = int(math.floor(self.straggler_frac * num_tasks))
        if n_strag:
            stragglers.update(
                int(t) for t in rng.choice(num_tasks, size=n_strag,
                                           replace=False))
        for t in stragglers:
            if not 0 <= t < num_tasks:
                raise ValueError(f"straggler task {t} out of range "
                                 f"[0, {num_tasks})")
            delays[t] *= self.straggler_factor

        dropped = np.zeros(num_tasks, bool)
        n_drop = int(math.floor(self.dropout_frac * num_tasks))
        if n_drop:
            dropped[rng.choice(num_tasks, size=n_drop, replace=False)] = True
        for t in self.dropout_tasks:
            if not 0 <= int(t) < num_tasks:
                raise ValueError(f"dropout task {t} out of range "
                                 f"[0, {num_tasks})")
            dropped[int(t)] = True

        waves = np.arange(num_tasks) // k
        dispatch_time = waves.astype(np.float64)
        arrival_time = np.where(dropped, np.inf, dispatch_time + delays)

        live = np.flatnonzero(~dropped)
        ev_time = np.concatenate([dispatch_time[live], arrival_time[live]])
        ev_kind = np.concatenate([np.full(live.size, DISPATCH, np.int32),
                                  np.full(live.size, ARRIVAL, np.int32)])
        ev_task = np.concatenate([live, live]).astype(np.int32)
        order = np.lexsort((ev_task, ev_kind, ev_time))
        ev_time, ev_kind, ev_task = (ev_time[order], ev_kind[order],
                                     ev_task[order])

        # sweep: greedy slot allocation + static staleness / fire / in-flight
        n_events = ev_kind.size
        slot = np.zeros(n_events, np.int32)
        staleness = np.zeros(n_events, np.int32)
        fire = np.zeros(n_events, bool)
        inflight = np.zeros(n_events, np.int32)
        slot_of = np.full(num_tasks, -1, np.int32)
        dispatch_version = np.zeros(num_tasks, np.int64)
        arrival_tasks = []
        free_slots: list = []
        allocated = 0
        arrivals = 0
        live_now = 0
        for e in range(n_events):
            t = int(ev_task[e])
            if ev_kind[e] == DISPATCH:
                if free_slots:
                    s = heapq.heappop(free_slots)
                else:
                    s = allocated
                    allocated += 1
                slot_of[t] = s
                dispatch_version[t] = arrivals // m
                live_now += 1
            else:
                s = int(slot_of[t])
                heapq.heappush(free_slots, s)
                staleness[e] = arrivals // m - dispatch_version[t]
                fire[e] = (arrivals + 1) % m == 0
                arrivals += 1
                arrival_tasks.append(t)
                live_now -= 1
            slot[e] = s
            inflight[e] = live_now

        return EventSchedule(
            kind=ev_kind, task=ev_task, slot=slot, staleness=staleness,
            fire=fire, inflight=inflight,
            dispatch_time=dispatch_time, arrival_time=arrival_time,
            dropped=dropped,
            arrival_tasks=np.asarray(arrival_tasks, np.int32),
            num_slots=max(allocated, 1), num_tasks=num_tasks,
            num_arrivals=arrivals, num_fires=arrivals // m,
            clients_per_round=k, num_rounds=self.num_rounds, buffer_size=m)


@dataclass
class EventSchedule:
    """A compiled arrival schedule: static event columns + timing model.

    Per-event columns (length ``num_events``): ``kind`` (DISPATCH/ARRIVAL),
    ``task`` (index into the trainer's stacked task data), ``slot``
    (in-flight store position), ``staleness`` (server versions between the
    task's dispatch and this arrival; 0 on dispatches), ``fire`` (this
    arrival completes a buffer of ``buffer_size``) and ``inflight``
    (dispatched-but-unarrived count after the event).

    Trailing arrivals that never complete a buffer (``num_arrivals %
    buffer_size``) are absorbed but never applied — the honest buffered
    semantics; ``num_fires`` counts the applies that actually happen.
    """

    kind: np.ndarray
    task: np.ndarray
    slot: np.ndarray
    staleness: np.ndarray
    fire: np.ndarray
    inflight: np.ndarray
    dispatch_time: np.ndarray   # (num_tasks,) wave-unit dispatch instants
    arrival_time: np.ndarray    # (num_tasks,) arrival instants (inf: dropped)
    dropped: np.ndarray         # (num_tasks,) bool
    arrival_tasks: np.ndarray   # (num_arrivals,) task ids in arrival order
    num_slots: int
    num_tasks: int
    num_arrivals: int
    num_fires: int
    clients_per_round: int
    num_rounds: int
    buffer_size: int

    @property
    def num_events(self) -> int:
        return int(self.kind.size)

    def event_arrays(self) -> Dict[str, np.ndarray]:
        """The event columns the async engine consumes."""
        return {"kind": self.kind, "task": self.task, "slot": self.slot,
                "staleness": self.staleness, "fire": self.fire,
                "inflight": self.inflight}

    def slice_events(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Event columns for the half-open range ``[lo, hi)``.

        The engine's :class:`~repro_torch.federated.async_engine.AsyncState`
        carries everything between events, so running ``[0, e)`` then
        ``[e, E)`` equals one ``[0, E)`` run: the contract the mid-run
        checkpoint/restore test pins.
        """
        return {k: v[lo:hi] for k, v in self.event_arrays().items()}

    # -- modeled (simulated-time) throughput --------------------------------
    def barrier_makespan(self) -> float:
        """Simulated time a synchronous barrier engine needs for all waves.

        Rounds serialize: each wave costs one dispatch-cadence unit plus the
        slowest *participating* client's delay (dropouts are generously
        assumed to be timed out at no cost — the barrier engine's best
        case). Deterministic given the sim's seed.
        """
        total = 0.0
        for r in range(self.num_rounds):
            tasks = np.arange(r * self.clients_per_round,
                              (r + 1) * self.clients_per_round)
            live = tasks[~self.dropped[tasks]]
            worst = (float((self.arrival_time[live]
                            - self.dispatch_time[live]).max())
                     if live.size else 0.0)
            total += 1.0 + worst
        return total

    def async_makespan(self) -> float:
        """Simulated time the buffered-async engine needs to absorb all
        arrivals: waves dispatch at unit cadence regardless of completion,
        so the makespan is the last arrival instant (plus the final wave's
        cadence unit)."""
        live = ~self.dropped
        if not live.any():
            return 0.0
        return float((self.arrival_time[live] + 1.0).max())

    def sim_speedup(self) -> float:
        """Barrier-over-async simulated-makespan ratio (>1: async absorbs
        clients faster). Both engines process the same arrival count, so
        the clients-per-sim-unit ratio reduces to the makespan ratio."""
        a = self.async_makespan()
        return self.barrier_makespan() / a if a > 0.0 else 1.0
