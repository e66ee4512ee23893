"""Thread supervision: heartbeat leases, bounded restarts, escalation
(counterpart of ``sheeprl_tpu/fault/supervisor.py``).

:class:`Supervisor` owns a pool of named workers, each a ``target(ctx)`` on
its own daemon thread. The :class:`WorkerContext` carries the heartbeat
(:meth:`WorkerContext.beat` renews a deadline lease: silence past it means
the worker is hung) and the cancellation verdict (``ctx.cancelled``: a
superseded generation must exit). :meth:`Supervisor.check` detects crashed
and hung workers and restarts, degrades or aborts as
``fault.supervisor.escalation`` says:

- ``restart``: always restart;
- ``degrade`` (default): restart up to ``max_restarts`` times with
  exponential backoff, then drop the worker; zero survivors raises
  :class:`AllWorkersDeadError`;
- ``abort``: the first worker past its budget raises
  :class:`WorkerAbortError`.

A restart runs the worker's ``on_restart`` hook, then spawns a fresh
generation; a hung generation is cancelled and abandoned (a wedged native
call cannot be preempted from Python). :meth:`Supervisor.join` stops every
worker under a time budget and names the ones it abandons. The serving tier
runs its scheduler worker and its checkpoint watcher under one supervisor
with a monitor thread (:meth:`Supervisor.start_monitor`).
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Supervisor",
    "WorkerContext",
    "WorkerHandle",
    "SupervisionError",
    "HungWorkerError",
    "WorkerAbortError",
    "AllWorkersDeadError",
]

_ESCALATIONS = ("restart", "degrade", "abort")

# worker states
_RUNNING = "running"
_BACKOFF = "backoff"  # dead, restart scheduled (exponential backoff pending)
_DEGRADED = "degraded"  # budget exhausted, dropped from the pool
_STOPPED = "stopped"  # exited after a stop request (normal shutdown)


class SupervisionError(RuntimeError):
    """Base class for supervision failures."""


class HungWorkerError(SupervisionError):
    """A worker's heartbeat lease expired while its thread was still alive."""


class WorkerAbortError(SupervisionError):
    """``escalation=abort``: a worker died past its restart budget."""

    def __init__(self, worker: str, cause: Optional[BaseException]) -> None:
        self.worker = worker
        self.cause = cause
        detail = f": {type(cause).__name__}: {cause}" if cause is not None else " (exited unexpectedly)"
        super().__init__(f"supervised worker '{worker}' died{detail}")


class AllWorkersDeadError(SupervisionError):
    """Zero survivors: every worker in the pool is dead or degraded."""

    def __init__(self, errors: Dict[str, Optional[BaseException]]) -> None:
        self.errors = dict(errors)
        lines = ", ".join(
            f"{name}: {type(e).__name__}: {e}" if e is not None else f"{name}: exited"
            for name, e in self.errors.items()
        )
        super().__init__(f"all supervised workers are dead ({lines})")


class WorkerContext:
    """Per-generation handle a worker target receives.

    ``beat()`` renews the heartbeat lease; ``cancelled`` is the exit verdict
    (supervisor stopping OR this generation superseded after a hang). The
    context itself implements ``is_set()`` so it can be passed wherever a
    ``threading.Event``-shaped stop flag is expected (e.g.
    ``RolloutQueue.put(stop_event=ctx)``).
    """

    def __init__(self, handle: "WorkerHandle", generation: int) -> None:
        self._handle = handle
        self.name = handle.name
        self.generation = generation
        self._cancel = threading.Event()

    def beat(self) -> None:
        self._handle._beat(self.generation)

    def retire(self) -> None:
        """Declare this worker's upcoming exit EXPECTED (its OWNER stopped it
        through its own flag, e.g. ``scheduler.stop()``, without routing
        through ``supervisor.request_stop()``): the next check treats the
        dead thread as stopped instead of crashed-and-restartable. Call as
        the worker's last act before returning."""
        handle = self._handle
        with handle.supervisor._lock:
            if handle.generation == self.generation and handle.state == _RUNNING:
                handle.state = _STOPPED

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set() or self._handle.supervisor.stop_event.is_set()

    def is_set(self) -> bool:  # Event protocol: usable as a stop flag
        return self.cancelled


class WorkerHandle:
    """One supervised worker: current thread/generation + lifetime counters."""

    def __init__(
        self,
        supervisor: "Supervisor",
        name: str,
        target: Callable[[WorkerContext], None],
        on_restart: Optional[Callable[[WorkerContext], None]],
        lease_s: Optional[float],
    ) -> None:
        self.supervisor = supervisor
        self.name = name
        self.target = target
        self.on_restart = on_restart
        self.lease_s = lease_s
        self.state = _RUNNING
        self.retired = False  # owner-side: no further restarts for this worker
        self.generation = 0
        self.thread: Optional[threading.Thread] = None
        self.ctx: Optional[WorkerContext] = None
        self.restarts = 0
        self.deaths = 0
        self.hangs = 0
        self.last_error: Optional[BaseException] = None
        self._errors: Dict[int, BaseException] = {}  # generation -> crash
        self._deadline = float("inf")
        self._not_before = 0.0  # backoff gate for the next restart

    # -- heartbeat ------------------------------------------------------------
    def _beat(self, generation: int) -> None:
        # a stale (cancelled/hung) generation must not refresh the live lease
        if generation == self.generation and self.lease_s is not None:
            # monotone max: a beat EXTENDS the deadline, never shrinks it —
            # the opening beat (before the first compiled dispatch) must not
            # collapse the first-dispatch grace back to the steady lease
            self._deadline = max(self._deadline, self.supervisor._clock() + self.lease_s)

    def _arm_lease(self, now: float) -> None:
        if self.lease_s is None:
            self._deadline = float("inf")
        else:
            # first-dispatch grace: the opening block of a worker typically
            # pays kernel builds and warm-up far longer than a steady-state lease
            self._deadline = now + max(self.lease_s, self.supervisor.grace_s)

    # -- owner-side lifecycle --------------------------------------------------
    def retire(self) -> None:
        """Owner-side: stop supervising this worker — no further restarts.
        Call from the owner's own ``stop()`` BEFORE joining the thread, so a
        crash racing the stop cannot be respawned by a monitor into the
        owner's shutdown settlement. (The worker-side twin is
        :meth:`WorkerContext.retire`, for a clean owner-flagged exit.)"""
        with self.supervisor._lock:
            self.retired = True
            if self.state == _BACKOFF or (self.state == _RUNNING and not self.is_alive()):
                self.state = _STOPPED

    # -- introspection --------------------------------------------------------
    def is_alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def live(self) -> bool:
        """Running-or-coming-back — the probe-facing liveness verdict (a
        worker in restart backoff counts as live, it will be back)."""
        with self.supervisor._lock:
            return self.state == _BACKOFF or (self.state == _RUNNING and self.is_alive())

    def info(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "alive": self.is_alive(),
            "generation": self.generation,
            "restarts": self.restarts,
            "deaths": self.deaths,
            "hangs": self.hangs,
            "last_error": f"{type(self.last_error).__name__}: {self.last_error}"
            if self.last_error is not None
            else None,
        }


class Supervisor:
    """Supervise a pool of worker threads (see module docstring).

    ``check()`` is the whole engine: the owner calls it periodically (or via
    :meth:`start_monitor`), and it restarts/degrades/aborts per the
    escalation policy. Nothing happens between checks — detection latency is
    the caller's poll cadence, which keeps the runtime deterministic enough
    to chaos-test.
    """

    def __init__(
        self,
        *,
        max_restarts: int = 2,
        backoff: float = 0.5,
        escalation: str = "degrade",
        lease_s: Optional[float] = 60.0,
        grace_s: float = 300.0,
        join_s: float = 30.0,
        name: str = "supervisor",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        escalation = str(escalation).lower()
        if escalation not in _ESCALATIONS:
            raise ValueError(f"Unknown fault.supervisor.escalation '{escalation}' ({'|'.join(_ESCALATIONS)})")
        self.max_restarts = max(0, int(max_restarts))
        self.backoff = max(0.0, float(backoff))
        self.escalation = escalation
        self.lease_s = float(lease_s) if lease_s else None
        self.grace_s = max(0.0, float(grace_s))
        self.join_s = max(0.0, float(join_s))
        self.name = name
        self._clock = clock
        self.stop_event = threading.Event()
        self.fatal: Optional[BaseException] = None  # set by the monitor thread
        self._lock = threading.RLock()
        self._workers: Dict[str, WorkerHandle] = {}
        self._monitor: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, cfg: Optional[Dict[str, Any]] = None, **defaults: Any) -> "Supervisor":
        """Build from a ``fault.supervisor``-shaped mapping; ``defaults``
        override the class defaults but lose to explicit config keys.
        ``enabled: False`` degenerates to fail-fast (0 restarts, abort) —
        the pre-supervision semantics, now with a typed, named error."""
        cfg = dict(cfg or {})
        merged: Dict[str, Any] = {}
        for key in ("max_restarts", "backoff", "escalation", "lease_s", "grace_s", "join_s", "name"):
            if cfg.get(key) is not None:
                merged[key] = cfg[key]
            elif key in defaults:
                merged[key] = defaults[key]
        if "lease_s" in cfg and not cfg["lease_s"]:  # explicit null/0 disables hang detection
            merged["lease_s"] = None
        if not cfg.get("enabled", True):
            merged["max_restarts"] = 0
            merged["escalation"] = "abort"
        return cls(**merged)

    # -- pool management ------------------------------------------------------
    def spawn(
        self,
        name: str,
        target: Callable[[WorkerContext], None],
        on_restart: Optional[Callable[[WorkerContext], None]] = None,
        lease_s: "float | None | str" = "default",
    ) -> WorkerHandle:
        """Start supervising ``target`` on a fresh daemon thread.

        ``lease_s="default"`` inherits the supervisor's lease; ``None``
        disables hang detection for this worker (crash-only supervision,
        e.g. a batch worker whose dispatch time is unbounded)."""
        with self._lock:
            if name in self._workers:
                raise ValueError(f"worker '{name}' is already supervised")
            lease = self.lease_s if lease_s == "default" else (float(lease_s) if lease_s else None)
            handle = WorkerHandle(self, name, target, on_restart, lease)
            self._workers[name] = handle
            self._start_thread(handle)
            return handle

    def worker(self, name: str) -> WorkerHandle:
        with self._lock:
            return self._workers[name]

    def _start_thread(self, handle: WorkerHandle) -> None:
        handle.generation += 1
        ctx = WorkerContext(handle, handle.generation)
        handle.ctx = ctx
        handle.state = _RUNNING
        handle._arm_lease(self._clock())

        def _runner() -> None:
            try:
                handle.target(ctx)
            except BaseException as e:  # noqa: BLE001 — the supervisor IS the handler
                with self._lock:
                    if ctx.generation == handle.generation:
                        handle._errors[ctx.generation] = e

        handle.thread = threading.Thread(target=_runner, name=handle.name, daemon=True)
        handle.thread.start()

    # -- the engine -----------------------------------------------------------
    def check(self) -> None:
        """One supervision pass: detect crashed/hung workers, run due
        restarts, escalate. Raises :class:`WorkerAbortError` /
        :class:`AllWorkersDeadError` per the policy; callers that must not
        die (the serve monitor) catch and surface via :attr:`fatal`."""
        if self.stop_event.is_set():
            return
        now = self._clock()
        with self._lock:
            for handle in self._workers.values():
                if handle.state == _RUNNING:
                    if not handle.is_alive():
                        error = handle._errors.pop(handle.generation, None)
                        self._on_death(handle, error, hang=False, now=now)
                    elif now > handle._deadline:
                        assert handle.ctx is not None
                        handle.ctx._cancel.set()  # the stale generation must exit if it ever wakes
                        err = HungWorkerError(
                            f"worker '{handle.name}' missed its {handle.lease_s:g}s heartbeat lease "
                            f"(generation {handle.generation} abandoned)"
                        )
                        self._on_death(handle, err, hang=True, now=now)
            # second sweep: run restarts that are DUE — including a zero-
            # backoff restart of a death detected in this same pass
            for handle in self._workers.values():
                if handle.retired:
                    if handle.state == _BACKOFF:
                        handle.state = _STOPPED  # owner stopped it: never respawn
                elif handle.state == _BACKOFF and now >= handle._not_before:
                    self._respawn(handle, now)
            live = sum(1 for h in self._workers.values() if h.state in (_RUNNING, _BACKOFF))
            dead = {name: h.last_error for name, h in self._workers.items() if h.state == _DEGRADED}
            # zero survivors is fatal only when at least one worker actually
            # DIED (degraded) — a pool whose workers all retired through
            # their owners' stop flags is shut down, not dead
            if live == 0 and dead:
                raise AllWorkersDeadError(dead)

    def _on_death(self, handle: WorkerHandle, error: Optional[BaseException], hang: bool, now: float) -> None:
        if self.stop_event.is_set() or handle.retired:
            handle.state = _STOPPED
            return
        handle.deaths += 1
        handle.hangs += int(hang)
        handle.last_error = error
        what = "hung (lease expired)" if hang else (
            f"crashed: {type(error).__name__}: {error}" if error is not None else "exited unexpectedly"
        )
        if self.escalation == "restart" or handle.restarts < self.max_restarts:
            delay = self.backoff * (2.0 ** handle.restarts)
            handle.state = _BACKOFF
            handle._not_before = now + delay
            warnings.warn(
                f"[{self.name}] worker '{handle.name}' {what} — restarting in {delay:g}s "
                f"(restart {handle.restarts + 1}"
                + ("" if self.escalation == "restart" else f"/{self.max_restarts}")
                + ")"
            )
        elif self.escalation == "degrade":
            handle.state = _DEGRADED
            warnings.warn(
                f"[{self.name}] worker '{handle.name}' {what} after {handle.restarts} restart(s) — "
                "DEGRADED: continuing on the surviving workers"
            )
        else:  # abort
            handle.state = _DEGRADED
            raise WorkerAbortError(handle.name, error)

    def _respawn(self, handle: WorkerHandle, now: float) -> None:
        handle.restarts += 1
        probe = WorkerContext(handle, handle.generation + 1)  # what _start_thread will create
        if handle.on_restart is not None:
            try:
                handle.on_restart(probe)
            except BaseException as e:  # re-homing failed: count it as another death
                handle.state = _RUNNING  # _on_death expects a live-ish handle
                self._on_death(handle, e, hang=False, now=now)
                return
        self._start_thread(handle)

    # -- introspection / metrics ----------------------------------------------
    def alive_count(self) -> int:
        """Workers currently running or pending a scheduled restart."""
        with self._lock:
            return sum(1 for h in self._workers.values() if h.state in (_RUNNING, _BACKOFF))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: h.info() for name, h in self._workers.items()}

    def metrics(self, prefix: str = "Pipeline/", noun: str = "worker") -> Dict[str, float]:
        """Counter dict for ``logger.log_dict`` (e.g. ``Pipeline/actor_deaths``,
        ``Pipeline/actors_live`` with ``noun="actor"``)."""
        with self._lock:
            deaths = sum(h.deaths for h in self._workers.values())
            restarts = sum(h.restarts for h in self._workers.values())
            hangs = sum(h.hangs for h in self._workers.values())
            live = sum(1 for h in self._workers.values() if h.state in (_RUNNING, _BACKOFF))
            degraded = sum(1 for h in self._workers.values() if h.state == _DEGRADED)
        return {
            f"{prefix}{noun}_deaths": deaths,
            f"{prefix}{noun}_restarts": restarts,
            f"{prefix}{noun}_hangs": hangs,
            f"{prefix}{noun}s_live": live,
            f"{prefix}{noun}s_degraded": degraded,
        }

    def describe(self) -> str:
        """One-line-per-worker diagnostics (handoff-timeout error payloads)."""
        now = self._clock()
        lines = []
        with self._lock:
            for name, h in self._workers.items():
                lease = "-" if h._deadline == float("inf") else f"{h._deadline - now:+.1f}s"
                err = f" last_error={type(h.last_error).__name__}: {h.last_error}" if h.last_error else ""
                lines.append(
                    f"{name}: state={h.state} alive={h.is_alive()} gen={h.generation} "
                    f"restarts={h.restarts} lease={lease}{err}"
                )
        return "; ".join(lines)

    # -- lifecycle ------------------------------------------------------------
    def request_stop(self) -> None:
        """Flag shutdown: workers see ``ctx.cancelled``, checks stop
        restarting, the monitor (if any) winds down."""
        self.stop_event.set()

    def join(self, budget_s: Optional[float] = None) -> List[str]:
        """Stop and join every worker under ``budget_s`` TOTAL (default: the
        configured ``join_s``). Workers still alive past the budget are
        logged and ABANDONED by name (daemon threads — a wedged native call
        cannot be preempted); returns their names."""
        self.request_stop()
        self.stop_monitor()
        budget = self.join_s if budget_s is None else float(budget_s)
        deadline = self._clock() + budget
        abandoned: List[str] = []
        with self._lock:
            handles = list(self._workers.values())
        for handle in handles:
            if handle.thread is None:
                continue
            handle.thread.join(timeout=max(0.0, deadline - self._clock()))
            if handle.thread.is_alive():
                abandoned.append(handle.name)
                if handle.ctx is not None:
                    handle.ctx._cancel.set()
            else:
                with self._lock:
                    # a crash that landed between the owner's last check()
                    # and shutdown must not vanish: surface it loudly (the
                    # run's work is done — a warning, not a failure)
                    late = handle._errors.pop(handle.generation, None)
                    if late is not None:
                        handle.last_error = late
                        warnings.warn(
                            f"[{self.name}] worker '{handle.name}' had crashed before shutdown "
                            f"completed: {type(late).__name__}: {late}"
                        )
                    if handle.state in (_RUNNING, _BACKOFF):
                        handle.state = _STOPPED
        if abandoned:
            warnings.warn(
                f"[{self.name}] shutdown join budget ({budget:g}s) expired — abandoning hung "
                f"worker thread(s): {', '.join(abandoned)} (daemon threads leaked deliberately; "
                "a wedged native call cannot be preempted from Python)"
            )
        return abandoned

    # -- optional monitor thread (serve tier) ---------------------------------
    def start_monitor(self, poll_s: float = 0.5) -> None:
        """Run :meth:`check` on a daemon thread every ``poll_s``. Typed
        supervision failures land in :attr:`fatal` (for a health probe)
        instead of being raised into nowhere."""
        if self._monitor is not None:
            return

        def _loop() -> None:
            while not self.stop_event.is_set():
                try:
                    self.check()
                except SupervisionError as e:
                    self.fatal = e
                    warnings.warn(f"[{self.name}] supervision failure: {e}")
                    return
                self.stop_event.wait(poll_s)

        self._monitor = threading.Thread(target=_loop, name=f"{self.name}-monitor", daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        monitor, self._monitor = self._monitor, None
        if monitor is not None and monitor.is_alive():
            self.stop_event.set()
            monitor.join(timeout=5.0)
