"""Process supervision: the subprocess twin of :mod:`.supervisor`
(counterpart of ``sheeprl_tpu/fault/procsup.py``).

The serve fleet's replicas and the flywheel's learner are processes, where
whole-process death (the OOM killer, a preemption, a fault in a native
library) and wedged processes (SIGSTOPped, stuck in a syscall) are routine.
:class:`ProcessSupervisor` carries the thread supervisor's semantics over to
``subprocess.Popen``:

- **the heartbeat is the owner's**: a process cannot be trusted to beat for
  itself, so the owner calls :meth:`ProcessSupervisor.beat` whenever the
  process answers its health probe (the fleet router) or rewrites its status
  file (the learner supervisor); silence past the lease means the process is
  HUNG though alive;
- **a kill is told apart from a hang**: ``proc.poll()`` returning a negative
  code is a death by signal (SIGKILL from outside: preemption, the OOM
  killer, a drill), counted in ``kills``; a lease expiry with the process
  alive counts in ``hangs``, and the supervisor SIGKILLs the wedged process
  itself before respawning it;
- **the same ladder and knobs**: ``restart`` / ``degrade`` / ``abort`` with
  ``max_restarts`` and exponential ``backoff``, from
  ``serve.fleet.{lease_s,grace_s,max_restarts,backoff,escalation,join_s}``,
  raising the thread supervisor's typed errors
  (:class:`~sheeprl_tpu_torch.fault.supervisor.WorkerAbortError`,
  :class:`~sheeprl_tpu_torch.fault.supervisor.AllWorkersDeadError`);
- **a restart re-runs the launch command**: a respawned replica's own
  checkpoint watcher (``serve.watch_publish_current``) adopts the newest
  complete save, so nothing crosses the process boundary; ``on_restart``
  runs first (the router re-homes the dead replica's sessions there).

:meth:`ProcessSupervisor.terminate_all` is the drain: SIGTERM every process
(each runs its own graceful drain and exits 0), wait ``grace_s``, SIGKILL the
rest by name. Nothing happens between :meth:`ProcessSupervisor.check` calls,
which the owner makes on its poll cadence.
"""

from __future__ import annotations

import signal
import subprocess
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.fault.supervisor import AllWorkersDeadError, SupervisionError, WorkerAbortError

__all__ = ["ProcessSupervisor", "ReplicaHandle", "ProcessHungError"]

_ESCALATIONS = ("restart", "degrade", "abort")

# process states (the thread supervisor's vocabulary)
_RUNNING = "running"
_BACKOFF = "backoff"  # dead, respawn scheduled (exponential backoff pending)
_DEGRADED = "degraded"  # budget exhausted, dropped
_STOPPED = "stopped"  # exited after a stop request (normal shutdown)


class ProcessHungError(SupervisionError):
    """A process's lease expired while it was alive."""


class ReplicaHandle:
    """One supervised process: its current ``Popen``, generation and counters."""

    def __init__(self, supervisor: "ProcessSupervisor", name: str, spawn_fn: Callable[[], subprocess.Popen],
                 on_restart: Optional[Callable[[str], None]], lease_s: Optional[float]) -> None:
        self.supervisor = supervisor
        self.name = name
        self.spawn_fn = spawn_fn
        self.on_restart = on_restart
        self.lease_s = lease_s
        self.state = _RUNNING
        self.retired = False  # owner-side: no further respawns
        self.generation = 0
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.deaths = 0
        self.hangs = 0  # lease expiries with the process alive
        self.kills = 0  # deaths by a signal from outside (rc < 0)
        self.last_rc: Optional[int] = None
        self.last_signal: Optional[str] = None
        self.last_error: Optional[str] = None
        self._deadline = float("inf")
        self._not_before = 0.0  # backoff gate of the next respawn

    def _beat(self) -> None:
        # a beat proves the start-up is over (the process answered), so it
        # shortens the spawn grace to the lease: a process that goes silent
        # right after becoming ready is caught within lease_s
        if self.lease_s is not None and self.state == _RUNNING:
            self._deadline = self.supervisor._clock() + self.lease_s

    def _arm_lease(self, now: float) -> None:
        if self.lease_s is None:
            self._deadline = float("inf")
        else:
            # the spawn grace: a fresh process pays imports, the card's
            # context and a checkpoint load before it can answer
            self._deadline = now + max(self.lease_s, self.supervisor.grace_s)

    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def is_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def live(self) -> bool:
        """Running, or in restart backoff (it will be back)."""
        with self.supervisor._lock:
            return self.state == _BACKOFF or (self.state == _RUNNING and self.is_alive())

    def retire(self) -> None:
        """Owner-side: no further respawns. Call before a deliberate stop, so
        a death racing it reads as stopped, not as a crash."""
        with self.supervisor._lock:
            self.retired = True
            if self.state == _BACKOFF or (self.state == _RUNNING and not self.is_alive()):
                self.state = _STOPPED

    def info(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "alive": self.is_alive(),
            "pid": self.pid(),
            "generation": self.generation,
            "restarts": self.restarts,
            "deaths": self.deaths,
            "hangs": self.hangs,
            "kills": self.kills,
            "last_rc": self.last_rc,
            "last_signal": self.last_signal,
            "last_error": self.last_error,
        }


class ProcessSupervisor:
    """Supervise named subprocesses (see the module docstring). The owner
    calls :meth:`beat` on each sign of life and :meth:`check` on its poll
    cadence; ``check`` detects deaths and hangs, runs due respawns and
    escalates."""

    def __init__(self, *, max_restarts: int = 3, backoff: float = 0.5, escalation: str = "degrade",
                 lease_s: Optional[float] = 15.0, grace_s: float = 120.0, join_s: float = 30.0,
                 name: str = "fleet", clock: Callable[[], float] = time.monotonic) -> None:
        escalation = str(escalation).lower()
        if escalation not in _ESCALATIONS:
            raise ValueError(f"Unknown serve.fleet.escalation '{escalation}' ({'|'.join(_ESCALATIONS)})")
        self.max_restarts = max(0, int(max_restarts))
        self.backoff = max(0.0, float(backoff))
        self.escalation = escalation
        self.lease_s = float(lease_s) if lease_s else None
        self.grace_s = max(0.0, float(grace_s))
        self.join_s = max(0.0, float(join_s))
        self.name = name
        self._clock = clock
        self.stopping = False
        self._lock = threading.RLock()
        self._replicas: Dict[str, ReplicaHandle] = {}

    @classmethod
    def from_config(cls, cfg: Optional[Dict[str, Any]] = None, **defaults: Any) -> "ProcessSupervisor":
        """From a ``serve.fleet``-shaped mapping; ``defaults`` override the
        class defaults but lose to keys the mapping sets. A ``lease_s`` set to
        null or 0 turns hang detection off."""
        cfg = dict(cfg or {})
        merged: Dict[str, Any] = {}
        for key in ("max_restarts", "backoff", "escalation", "lease_s", "grace_s", "join_s", "name"):
            if cfg.get(key) is not None:
                merged[key] = cfg[key]
            elif key in defaults:
                merged[key] = defaults[key]
        if "lease_s" in cfg and not cfg["lease_s"]:
            merged["lease_s"] = None
        return cls(**merged)

    # -- the processes ---------------------------------------------------------
    def spawn(self, name: str, spawn_fn: Callable[[], subprocess.Popen],
              on_restart: Optional[Callable[[str], None]] = None,
              lease_s: "float | None | str" = "default") -> ReplicaHandle:
        """Launch ``spawn_fn()`` and supervise it. ``on_restart(name)`` runs
        before every respawn; ``lease_s="default"`` takes the supervisor's
        lease, None turns hang detection off for this process."""
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica '{name}' is already supervised")
            lease = self.lease_s if lease_s == "default" else (float(lease_s) if lease_s else None)
            handle = ReplicaHandle(self, name, spawn_fn, on_restart, lease)
            self._replicas[name] = handle
            self._launch(handle)
            return handle

    def replica(self, name: str) -> ReplicaHandle:
        with self._lock:
            return self._replicas[name]

    def replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._replicas.values())

    def beat(self, name: str) -> None:
        """A sign of life from ``name``: renews its lease."""
        with self._lock:
            handle = self._replicas.get(name)
            if handle is not None:
                handle._beat()

    def _launch(self, handle: ReplicaHandle) -> None:
        handle.generation += 1
        handle.state = _RUNNING
        handle._arm_lease(self._clock())
        handle.proc = handle.spawn_fn()

    # -- the engine ------------------------------------------------------------
    def check(self) -> None:
        """One pass: detect dead and hung processes, run due respawns,
        escalate. Raises :class:`WorkerAbortError` or
        :class:`AllWorkersDeadError` as the policy says."""
        if self.stopping:
            return
        now = self._clock()
        hang_victims: List[ReplicaHandle] = []
        with self._lock:
            for handle in self._replicas.values():
                if handle.state != _RUNNING or handle.proc is None:
                    continue
                rc = handle.proc.poll()
                if rc is not None:
                    handle.last_rc = rc
                    if rc < 0:  # killed by a signal: a kill, not a hang
                        handle.kills += 1
                        try:
                            handle.last_signal = signal.Signals(-rc).name
                        except ValueError:
                            handle.last_signal = f"signal {-rc}"
                        what = f"killed by {handle.last_signal}"
                    else:
                        handle.last_signal = None
                        what = f"exited rc={rc}"
                    self._on_death(handle, what, now=now)
                elif now > handle._deadline:
                    # alive but silent past its lease: only SIGKILL preempts a
                    # wedged process; the kill and its reap run outside the
                    # lock, which every beat and health answer takes
                    handle.hangs += 1
                    handle._deadline = float("inf")  # claimed: handled once
                    hang_victims.append(handle)
        for handle in hang_victims:
            try:
                handle.proc.kill()
                handle.proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        with self._lock:
            for handle in hang_victims:
                if handle.state != _RUNNING:  # stopped or retired meanwhile
                    continue
                handle.last_rc = handle.proc.poll()
                handle.last_signal = None
                self._on_death(handle, f"hung: missed its {handle.lease_s:g}s health-probe lease (SIGKILLed "
                                       f"generation {handle.generation})", now=now)
            # the respawns that are due, a zero-backoff one of this pass's death included
            for handle in self._replicas.values():
                if handle.retired:
                    if handle.state == _BACKOFF:
                        handle.state = _STOPPED
                elif handle.state == _BACKOFF and now >= handle._not_before:
                    self._respawn(handle)
            live = sum(1 for h in self._replicas.values() if h.state in (_RUNNING, _BACKOFF))
            dead = {name: RuntimeError(h.last_error or "replica dead")
                    for name, h in self._replicas.items() if h.state == _DEGRADED}
            if live == 0 and dead:
                raise AllWorkersDeadError(dead)

    def _on_death(self, handle: ReplicaHandle, what: str, now: float) -> None:
        if self.stopping or handle.retired:
            handle.state = _STOPPED
            return
        handle.deaths += 1
        handle.last_error = what
        if self.escalation == "restart" or handle.restarts < self.max_restarts:
            delay = self.backoff * (2.0 ** handle.restarts)
            handle.state = _BACKOFF
            handle._not_before = now + delay
            warnings.warn(
                f"[{self.name}] replica '{handle.name}' {what} — respawning in {delay:g}s "
                f"(restart {handle.restarts + 1}" + ("" if self.escalation == "restart" else f"/{self.max_restarts}")
                + ")"
            )
        elif self.escalation == "degrade":
            handle.state = _DEGRADED
            warnings.warn(f"[{self.name}] replica '{handle.name}' {what} after {handle.restarts} restart(s) — "
                          "DEGRADED: continuing on the surviving replicas")
        else:
            handle.state = _DEGRADED
            raise WorkerAbortError(handle.name, RuntimeError(what))

    def _respawn(self, handle: ReplicaHandle) -> None:
        handle.restarts += 1
        if handle.on_restart is not None:
            try:
                handle.on_restart(handle.name)
            except Exception as e:  # the hook failed: another death
                handle.state = _RUNNING
                self._on_death(handle, f"on_restart hook failed: {type(e).__name__}: {e}", now=self._clock())
                return
        try:
            self._launch(handle)
        except Exception as e:  # the spawn itself failed
            handle.state = _RUNNING
            self._on_death(handle, f"respawn failed: {type(e).__name__}: {e}", now=self._clock())

    # -- introspection ---------------------------------------------------------
    def alive_count(self) -> int:
        """Processes running or waiting for a scheduled respawn."""
        with self._lock:
            return sum(1 for h in self._replicas.values() if h.state in (_RUNNING, _BACKOFF))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: h.info() for name, h in self._replicas.items()}

    def metrics(self, prefix: str = "Fleet/", noun: str = "replica") -> Dict[str, float]:
        with self._lock:
            hs = list(self._replicas.values())
            return {
                f"{prefix}{noun}_deaths": sum(h.deaths for h in hs),
                f"{prefix}{noun}_restarts": sum(h.restarts for h in hs),
                f"{prefix}{noun}_hangs": sum(h.hangs for h in hs),
                f"{prefix}{noun}_kills": sum(h.kills for h in hs),
                f"{prefix}{noun}s_live": sum(1 for h in hs if h.state in (_RUNNING, _BACKOFF)),
                f"{prefix}{noun}s_degraded": sum(1 for h in hs if h.state == _DEGRADED),
            }

    def describe(self) -> str:
        """One line per process, for diagnostics."""
        now = self._clock()
        lines = []
        with self._lock:
            for name, h in self._replicas.items():
                lease = "-" if h._deadline == float("inf") else f"{h._deadline - now:+.1f}s"
                err = f" last_error={h.last_error}" if h.last_error else ""
                lines.append(f"{name}: state={h.state} pid={h.pid()} gen={h.generation} restarts={h.restarts} "
                             f"lease={lease}{err}")
        return "; ".join(lines)

    # -- lifecycle -------------------------------------------------------------
    def request_stop(self) -> None:
        """Shutdown: checks respawn nothing, deaths read as stopped."""
        self.stopping = True

    def terminate_all(self, grace_s: Optional[float] = None) -> List[str]:
        """The drain: SIGTERM every live process, wait ``grace_s`` in all
        (default ``join_s``), SIGKILL the rest by name; returns their names."""
        self.request_stop()
        budget = self.join_s if grace_s is None else float(grace_s)
        with self._lock:
            handles = [h for h in self._replicas.values() if h.proc is not None]
            for h in handles:
                h.retired = True
        for h in handles:
            if h.proc.poll() is None:
                try:
                    h.proc.terminate()
                except OSError:
                    pass
        deadline = self._clock() + budget
        killed: List[str] = []
        for h in handles:
            try:
                h.proc.wait(timeout=max(0.0, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                killed.append(h.name)
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            with self._lock:
                h.last_rc = h.proc.poll()
                if h.state in (_RUNNING, _BACKOFF):
                    h.state = _STOPPED
        if killed:
            warnings.warn(f"[{self.name}] drain grace ({budget:g}s) expired — SIGKILLed replica(s) that did not "
                          f"finish their graceful drain: {', '.join(killed)}")
        return killed
