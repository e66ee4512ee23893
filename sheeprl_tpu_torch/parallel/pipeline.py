"""Sebulba pipeline primitives (counterpart of
``sheeprl_tpu/parallel/pipeline.py``): the bounded handoff between actor
threads and the learner, versioned parameter snapshots, and host->device
staging of finished rollouts.

:class:`RolloutQueue`
    A bounded FIFO. ``put`` blocks while the learner is behind
    (back-pressure is the only rate coupling between the two sides), stays
    interruptible by a stop flag and renews a supervised producer's
    heartbeat while it waits; both sides' blocked time goes into
    :class:`PipelineStats` (``Pipeline/*`` metrics).

:class:`ParamServer`
    Versioned parameters. The JAX package publishes by swapping a reference,
    which is safe there because JAX arrays never change. Here the learner's
    optimizers update the parameters in place, so :meth:`ParamServer.publish`
    COPIES them into a snapshot module that no optimizer touches, on the
    learner's stream, and records a CUDA event after the copy.
    :meth:`ParamServer.pull` hands an actor the newest snapshot (with
    ``prefer_ready``, the newest whose copy has run) and makes the
    actor's stream wait on that event before any read;
    :meth:`ParamServer.release` records an event on the actor's stream when
    it is done with the version. A snapshot is reused for a later version
    only when no actor holds it, and the learner's stream first waits on its
    readers' release events. The port runs on one device, so the snapshot of
    a version is the one copy every actor shares (JAX caches one placed copy
    per device).

:class:`DoubleBufferedStager`
    A ring of host slabs, each one contiguous byte buffer (pinned when the
    target is a CUDA device) with one view per key that the actor fills row
    by row. :meth:`DoubleBufferedStager.upload` sends a slab in ONE
    non-blocking copy on the caller's (the actor's) stream; a slab is refilled
    only after that copy's event has completed. :meth:`StagedItem.record`
    closes an item with an event on the producer's stream, and
    :meth:`StagedItem.wait` makes the consumer's stream wait on it and covers
    every tensor with ``record_stream``, so the caching allocator cannot hand
    the memory back to the actor while the learner still reads it. On the
    CPU an upload aliases its slab (the JAX CPU backend's zero-copy
    ``device_put``), so there the ring is what keeps an item intact while it
    is queued or trained on: size it ``queue_depth + env_groups + 3``, as
    the JAX package does.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.data.ring import BlobLayout, make_layout, unpack_burst_blob
from sheeprl_tpu_torch.fault.inject import fault_point

__all__ = [
    "HandoffTimeoutError",
    "PipelineStats",
    "RolloutQueue",
    "ParamServer",
    "DoubleBufferedStager",
    "StagedItem",
    "staleness_bound",
    "supervised_actor_pool",
    "fold_seed",
    "side_stream",
    "stream_id",
]


def fold_seed(base_state: torch.Tensor, *ids: int) -> int:
    """A 64-bit seed of a generator's state and some integers: the actors'
    counterpart of ``jax.random.fold_in(fold_in(key, actor), generation)``.
    The base generator is not advanced, so its state is what a checkpoint
    keeps and a resume restores."""
    digest = int.from_bytes(hashlib.sha256(base_state.numpy().tobytes()).digest()[:8], "little")
    return int(np.random.SeedSequence([digest, *[int(i) for i in ids]]).generate_state(1, np.uint64)[0])


def stream_id(device: "torch.device | str") -> Optional[int]:
    """The current stream's CUDA handle on ``device`` (0 is the legacy
    default stream), None on the CPU: what a run records of the streams its
    threads worked on."""
    device = torch.device(device)
    return int(torch.cuda.current_stream(device).cuda_stream) if device.type == "cuda" else None


def side_stream(device: "torch.device | str"):
    """``(stream, context)``: on a CUDA device a stream of the actor's own
    (PyTorch's pool streams do not synchronize with the legacy default
    stream, which the learner may run on) and the context that makes it
    current; on the CPU ``(None, nullcontext())``."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, contextlib.nullcontext()
    stream = torch.cuda.Stream(device=device)
    return stream, torch.cuda.stream(stream)


def supervised_actor_pool(sup_cfg: Optional[Mapping[str, Any]], name: str, stats: "PipelineStats"):
    """A ``fault.supervisor``-configured
    :class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor` for an actor
    pool, and the learner's handoff deadline as a callable for
    :meth:`RolloutQueue.get`: ``handoff_deadline_s`` (null or 0: none),
    widened by the supervisor's ``grace_s`` until the first item arrives
    (the actors' first rollout pays kernel builds and warm-up). Returns
    ``(supervisor, handoff_deadline_fn)``."""
    from sheeprl_tpu_torch.fault.supervisor import Supervisor

    sup_cfg = dict(sup_cfg or {})
    supervisor = Supervisor.from_config(sup_cfg, name=name)
    handoff_deadline = float(sup_cfg.get("handoff_deadline_s", 120.0) or 0) or None

    def _deadline() -> Optional[float]:
        if handoff_deadline is None:
            return None
        return handoff_deadline + (0.0 if stats.rollouts_consumed else supervisor.grace_s)

    return supervisor, _deadline


class HandoffTimeoutError(RuntimeError):
    """The learner starved past its deadline while its producers claim to be
    live: the actors are hung or stuck (not slow, and not all dead, which is
    the supervisor's ``AllWorkersDeadError``). Carries their diagnostics."""


def staleness_bound(queue_depth: int, in_flight: int, publish_every: int) -> int:
    """Steady-state staleness, in published versions, of a rollout when the
    learner trains on it: behind it wait at most ``queue_depth`` queued
    items, ``in_flight`` items being collected (actors x rollout slices per
    pull) and the learner's current one, and the learner publishes every
    ``publish_every`` updates, so ``ceil((queue_depth + in_flight + 1) /
    publish_every)``. Exact with one producer (FIFO); with several, rollout
    jitter can pass it for a moment, which the ``Pipeline/*`` gauges show."""
    return math.ceil((queue_depth + in_flight + 1) / max(1, publish_every))


class PipelineStats:
    """Thread-safe counters of the actor-learner handoff."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rollouts_produced = 0
        self.rollouts_consumed = 0
        self.rollouts_dropped = 0  # items a stop turned away from a full queue
        self.actor_stall_s = 0.0  # time actors spent blocked on a full queue
        self.learner_starved_s = 0.0  # time the learner waited on an empty queue
        self.publishes = 0
        self.pulls = 0
        self.ready_fallbacks = 0  # prefer_ready pulls that took an older, copied snapshot
        self.max_depth_seen = 0
        self.max_staleness_seen = 0
        self.last_staleness = 0
        self.staleness_hist: Dict[int, int] = {}
        # off-policy pipelines: consumed env steps and gradient steps, so the
        # achieved replay ratio is a gauge of its own
        self.env_steps = 0
        self.grad_steps = 0

    def add(self, field: str, value: float) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + value)

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self.max_depth_seen = max(self.max_depth_seen, depth)

    def observe_staleness(self, staleness: int) -> None:
        with self._lock:
            self.last_staleness = staleness
            self.max_staleness_seen = max(self.max_staleness_seen, staleness)
            self.staleness_hist[staleness] = self.staleness_hist.get(staleness, 0) + 1

    def snapshot(self) -> Dict[str, float]:
        """The ``Pipeline/*`` metrics."""
        with self._lock:
            out = {
                "Pipeline/rollouts_produced": self.rollouts_produced,
                "Pipeline/rollouts_consumed": self.rollouts_consumed,
                "Pipeline/rollouts_dropped": self.rollouts_dropped,
                "Pipeline/actor_stall_s": round(self.actor_stall_s, 4),
                "Pipeline/learner_starved_s": round(self.learner_starved_s, 4),
                "Pipeline/publishes": self.publishes,
                "Pipeline/param_staleness": self.last_staleness,
                "Pipeline/max_queue_depth": self.max_depth_seen,
            }
            if self.env_steps > 0:
                out["Pipeline/env_steps_consumed"] = self.env_steps
                out["Pipeline/grad_steps"] = self.grad_steps
                out["Pipeline/replay_ratio_actual"] = round(self.grad_steps / self.env_steps, 4)
            return out


class RolloutQueue:
    """Bounded FIFO between actor threads and the learner (see the module
    docstring). Producers blocked on a full queue are admitted in the order
    they arrived (a ticket each), so one actor cannot keep another's item
    out while the learner moves on: what keeps :func:`staleness_bound` with
    several actors. (JAX's ``queue.Queue`` polled with timeouts admits its
    waiters in no set order.)"""

    def __init__(self, depth: int, stats: Optional[PipelineStats] = None) -> None:
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self.stats = stats or PipelineStats()
        self._cv = threading.Condition()
        self._items: "collections.deque[Any]" = collections.deque()
        self._next_ticket = 0  # the next arriving producer's ticket
        self._serving = 0  # the ticket admitted next
        self._abandoned: set = set()  # tickets a stop turned away before their turn
        self._starved_since: Optional[float] = None

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)

    def _advance(self) -> None:
        self._serving += 1
        while self._serving in self._abandoned:
            self._abandoned.discard(self._serving)
            self._serving += 1

    def put(self, item: Any, stop_event: Optional[Any] = None, poll_s: float = 0.05,
            beat: Optional[Callable[[], None]] = None) -> bool:
        """Enqueue; False (the item dropped) if ``stop_event`` (anything with
        ``is_set()``, a supervised worker's context too) fires while the
        queue is full. ``beat`` is called at every poll while blocked: a
        back-pressured producer is healthy and keeps its lease."""
        fault_point("pipeline.queue.put")
        with self._cv:
            ticket = self._next_ticket
            self._next_ticket += 1
            start = None
            while self._serving != ticket or len(self._items) >= self.depth:
                if start is None:
                    start = time.perf_counter()
                if stop_event is not None and stop_event.is_set():
                    if self._serving == ticket:
                        self._advance()
                    else:
                        self._abandoned.add(ticket)
                    self._cv.notify_all()
                    self.stats.add("actor_stall_s", time.perf_counter() - start)
                    self.stats.add("rollouts_dropped", 1)
                    return False
                if beat is not None:
                    beat()
                self._cv.wait(poll_s)
            self._items.append(item)
            self._advance()
            depth = len(self._items)
            self._cv.notify_all()
        if start is not None:
            self.stats.add("actor_stall_s", time.perf_counter() - start)
        self.stats.add("rollouts_produced", 1)
        self.stats.observe_depth(depth)
        return True

    def get(self, timeout: Optional[float] = None, deadline_s: Optional[float] = None,
            diagnose: Optional[Callable[[], str]] = None) -> Any:
        """Dequeue; ``queue.Empty`` on timeout (``None``: wait as long as it
        takes). Any wait counts as starvation. With ``deadline_s``,
        consecutive empty gets past it raise :class:`HandoffTimeoutError`
        with ``diagnose()``'s text; an item resets the clock."""
        fault_point("pipeline.queue.get")
        start = time.perf_counter()
        with self._cv:
            got = self._cv.wait_for(lambda: len(self._items) > 0, timeout=timeout)
            if got:
                item = self._items.popleft()
                self._cv.notify_all()
        if not got:
            if deadline_s is not None:
                if self._starved_since is None:
                    self._starved_since = start
                starved = time.perf_counter() - self._starved_since
                if starved >= deadline_s:
                    detail = ""
                    if diagnose is not None:
                        try:
                            detail = f" Producers: {diagnose()}"
                        except Exception:  # diagnostics never mask the timeout
                            pass
                    raise HandoffTimeoutError(
                        f"rollout handoff starved for {starved:.2f}s (deadline {deadline_s:g}s, "
                        f"queue depth {self.qsize()}/{self.depth}, {self.stats.rollouts_produced} produced / "
                        f"{self.stats.rollouts_consumed} consumed).{detail}"
                    )
            raise queue.Empty
        self._starved_since = None
        waited = time.perf_counter() - start
        if waited > 1e-4:
            self.stats.add("learner_starved_s", waited)
        self.stats.add("rollouts_consumed", 1)
        return item

    def drain(self) -> List[Any]:
        """Take everything pending (shutdown); returns the items."""
        with self._cv:
            items = list(self._items)
            self._items.clear()
            self._cv.notify_all()
        return items


def _cuda(device: torch.device) -> bool:
    return torch.device(device).type == "cuda"


class _Snapshot:
    """One published version: a frozen copy of the module, the event after
    its copy, the actors holding it and the events their reads end with."""

    def __init__(self, module: nn.Module) -> None:
        self.module = copy.deepcopy(module).requires_grad_(False)
        tensors = [*self.module.parameters(), *self.module.buffers()]
        self.tensors = tensors
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self.version = 0
        self.writing = True
        self.event: Optional[torch.cuda.Event] = None
        self.holders = 0
        self.released: List[torch.cuda.Event] = []


class ParamServer:
    """Versioned parameter snapshots between the learner and the actors (see
    the module docstring). ``module`` is the learner's live module (PPO: the
    agent; SAC: its actor); nothing is published until :meth:`publish`."""

    def __init__(self, module: nn.Module, publish_every: int = 1, stats: Optional[PipelineStats] = None) -> None:
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {publish_every}")
        self.publish_every = publish_every
        self.stats = stats or PipelineStats()
        self.module = module
        self._lock = threading.Lock()
        self._version = 0
        self._current: Optional[_Snapshot] = None
        self._pool: List[_Snapshot] = []
        self._by_version: Dict[int, _Snapshot] = {}

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def snapshots(self) -> int:
        """Snapshot modules allocated so far (a reused one counts once)."""
        with self._lock:
            return len(self._pool)

    def _free_snapshot(self) -> _Snapshot:
        """A snapshot no actor holds and that is not the newest (the
        learner is the only writer), else a new one."""
        with self._lock:
            for snap in self._pool:
                if snap is not self._current and snap.holders == 0 and not snap.writing:
                    self._by_version.pop(snap.version, None)
                    snap.writing = True
                    return snap
        snap = _Snapshot(self.module)
        with self._lock:
            self._pool.append(snap)
        return snap

    @torch.no_grad()
    def publish(self) -> int:
        """Copy the module into a free snapshot on the current (the
        learner's) stream and make it the newest version; returns the
        version."""
        snap = self._free_snapshot()
        on_card = snap.device.type == "cuda"
        if on_card:
            stream = torch.cuda.current_stream(snap.device)
            for event in snap.released:  # the readers of its last version are done with it
                stream.wait_event(event)
        snap.released = []
        torch._foreach_copy_(snap.tensors, [t.detach() for t in (*self.module.parameters(), *self.module.buffers())])
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(snap.device))
        with self._lock:
            self._version += 1
            snap.version, snap.event, snap.writing = self._version, event, False
            self._by_version[snap.version] = snap
            self._current = snap
            version = self._version
        self.stats.add("publishes", 1)
        return version

    def maybe_publish(self, update_idx: int) -> bool:
        """Publish iff ``update_idx`` (1-based) is a multiple of
        ``publish_every``."""
        if update_idx % self.publish_every == 0:
            self.publish()
            return True
        return False

    def pull(self, prefer_ready: bool = False) -> Tuple[int, nn.Module]:
        """The newest snapshot ``(version, module)``, held for the caller
        until :meth:`release`; the caller's current stream waits for its
        copy. Raises before the first publish.

        ``prefer_ready`` (JAX ``pull(prefer_ready=True)``, newest-ready-wins):
        the newest snapshot whose copy event has completed, and the newest
        one when none has. A publish queues its copy behind the learner's
        work on its stream, so an actor that takes the newest version waits
        for that work before its act step; this one acts on the previous
        version meanwhile. On the CPU, where snapshots have no event, it is
        newest-wins."""
        with self._lock:
            snap = self._current
            if snap is None:
                raise RuntimeError("ParamServer.pull before the first publish")
            if prefer_ready and snap.event is not None and not snap.event.query():
                ready = [s for s in self._by_version.values()
                         if not s.writing and (s.event is None or s.event.query())]
                if ready:
                    snap = max(ready, key=lambda s: s.version)
                    self.stats.add("ready_fallbacks", 1)
            snap.holders += 1
            version, event = snap.version, snap.event
        self.stats.add("pulls", 1)
        if event is not None and snap.device.type == "cuda":
            torch.cuda.current_stream(snap.device).wait_event(event)
        return version, snap.module

    def release(self, version: int) -> None:
        """The caller is done with ``version``: its reads, queued on its
        current stream, end with an event the next writer of the snapshot
        waits on."""
        with self._lock:
            snap = self._by_version.get(version)
            if snap is None or snap.holders <= 0:
                raise RuntimeError(f"release of version {version}, which is not held")
        event = None
        if snap.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(snap.device))
        with self._lock:
            if event is not None:
                snap.released.append(event)
            snap.holders -= 1


class StagedItem:
    """Tensors one producer stream made, closed by an event on that stream."""

    def __init__(self, data: Dict[str, torch.Tensor], event: Optional[torch.cuda.Event]) -> None:
        self.data = data
        self.event = event

    @classmethod
    def record(cls, data: Dict[str, torch.Tensor]) -> "StagedItem":
        """Close ``data``: an event on the current stream of its device when
        it lies on a CUDA device, none on the CPU."""
        first = next(iter(data.values()))
        event = None
        if first.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(first.device))
        return cls(data, event)

    def wait(self) -> Dict[str, torch.Tensor]:
        """The data, safe to read on the current stream: it waits on the
        producer's event, and ``record_stream`` keeps each tensor's memory
        from the allocator until this stream's work on it is done."""
        if self.event is not None:
            first = next(iter(self.data.values()))
            stream = torch.cuda.current_stream(first.device)
            stream.wait_event(self.event)
            for t in self.data.values():
                t.record_stream(stream)
        return self.data


class _Slab(dict):
    """One host slab: a dict of numpy views into one contiguous byte buffer."""

    def __init__(self, layout: BlobLayout, pinned: bool) -> None:
        blob = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=pinned)
        raw = blob.numpy()
        super().__init__({
            name: raw[off : off + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
            for name, off, shape, dtype in layout.segments
        })
        self.blob = blob
        self.layout = layout
        self.event: Optional[torch.cuda.Event] = None


class DoubleBufferedStager:
    """Ring-buffered host->device staging (see the module docstring): one
    packed upload per item, a ring of ``slots`` slabs."""

    def __init__(self, device: "torch.device | str", slots: int = 2) -> None:
        if slots < 2:
            raise ValueError(f"stager needs at least 2 slots, got {slots}")
        self.device = torch.device(device)
        self.slots = slots
        self._ring: List[_Slab] = []
        self._idx = 0
        self._layout: Optional[BlobLayout] = None

    def acquire(self, template: Mapping[str, Tuple[tuple, Any]]) -> _Slab:
        """The next slab for direct writes, ``template`` mapping each key to
        ``(shape, dtype)``; on a CUDA device it first waits until the slab's
        last upload has run."""
        layout = make_layout([(k, shape, np.dtype(dtype)) for k, (shape, dtype) in template.items()])
        if self._layout is None:
            self._layout = layout
            self._ring = [_Slab(layout, _cuda(self.device)) for _ in range(self.slots)]
        elif layout != self._layout:
            raise ValueError("DoubleBufferedStager.acquire: one stager stages one layout")
        slab = self._ring[self._idx]
        self._idx = (self._idx + 1) % self.slots
        if slab.event is not None:
            slab.event.synchronize()
            slab.event = None
        return slab

    def upload(self, slab: _Slab) -> Dict[str, torch.Tensor]:
        """``slab`` on the device: ONE non-blocking copy on the current
        stream (an event after it gates the slab's refill), each key a view of
        the copy. On the CPU the views alias the slab itself."""
        if not _cuda(self.device):
            return unpack_burst_blob(slab.blob, slab.layout)
        on_device = slab.blob.to(self.device, non_blocking=True)
        slab.event = torch.cuda.Event()
        slab.event.record(torch.cuda.current_stream(self.device))
        return unpack_burst_blob(on_device, slab.layout)
