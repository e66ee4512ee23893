"""Gang supervision of a pod of training workers (counterpart of
``sheeprl_tpu/fault/podsup.py``).

A serve fleet restarts replicas one at a time: they are independent. The N
workers of a training pod are the opposite: they jointly own one
``torch.distributed`` process group, and a group cannot take a respawned
rank back in, so any worker's failure condemns the whole generation.

- **Detection is inherited.** :class:`PodSupervisor` runs
  :class:`~sheeprl_tpu_torch.fault.procsup.ProcessSupervisor`'s engine: a
  death with ``rc < 0`` counts in ``kills``, a heartbeat lease expired with
  the process alive counts in ``hangs`` (the supervisor SIGKILLs the wedged
  worker itself).
- **Recovery is a gang restart.** The first abnormal death of a generation
  marks the gang dirty; the survivors are drained (SIGTERM, ``drain_s`` for
  their own checkpoint-and-exit, then SIGKILL: a survivor blocked in a
  collective with a dead peer never reaches its drain check) and the whole
  pod respawns. ``rc == 0`` is a worker that finished training, never a
  trigger.
- **The same ladder and knobs.** ``restart`` / ``degrade`` / ``abort``,
  ``max_restarts`` and exponential ``backoff`` (``fabric.pod.*``), with the
  thread supervisor's typed errors. A pod cannot train on part of its
  group, so ``degrade`` past the budget is a stop raising
  :class:`~sheeprl_tpu_torch.fault.supervisor.AllWorkersDeadError`.

The launcher (:mod:`sheeprl_tpu_torch.parallel.pod`) owns what is particular
to training (commands, heartbeat files, the resume checkpoint and its step
fence) through ``on_gang_restart(generation)``, which runs before the new
generation spawns.
"""

from __future__ import annotations

import subprocess
import warnings
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.fault.procsup import _DEGRADED, _RUNNING, _STOPPED, ProcessSupervisor, ReplicaHandle
from sheeprl_tpu_torch.fault.supervisor import AllWorkersDeadError, WorkerAbortError

__all__ = ["PodSupervisor"]

# gang states (each worker keeps procsup's own)
_GANG_IDLE = "idle"
_GANG_BACKOFF = "backoff"  # the dirty generation drained, its respawn scheduled
_GANG_DEGRADED = "degraded"  # the budget spent: stopped, a typed error raised


class PodSupervisor(ProcessSupervisor):
    """Supervise N training workers as one gang (see the module docstring).
    The owner calls :meth:`beat` per worker heartbeat and :meth:`check` on
    its poll cadence; ``check`` detects deaths and hangs, then runs the gang
    ladder in place of per-worker respawns."""

    def __init__(self, *, drain_s: float = 5.0, on_gang_restart: Optional[Callable[[int], None]] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.drain_s = max(0.0, float(drain_s))
        self.on_gang_restart = on_gang_restart
        self.pod_restarts = 0  # gang respawns made
        self.generation = 0  # 1 for the first spawn_gang
        self._gang_state = _GANG_IDLE
        self._gang_reason: Optional[str] = None
        self._gang_not_before = 0.0

    @classmethod
    def from_config(cls, cfg: Optional[Dict[str, Any]] = None, **defaults: Any) -> "PodSupervisor":
        """From a ``fabric.pod``-shaped mapping: procsup's merge, plus
        ``drain_s``."""
        cfg = dict(cfg or {})
        drain = cfg.get("drain_s")
        if drain is None:
            drain = defaults.pop("drain_s", 5.0)
        else:
            defaults.pop("drain_s", None)
        sup = super().from_config(cfg, **defaults)
        sup.drain_s = max(0.0, float(drain))
        return sup

    # -- the gang ----------------------------------------------------------------
    def spawn_gang(self, spawners: Dict[str, Callable[[], subprocess.Popen]]) -> List[ReplicaHandle]:
        """Launch every worker of the first generation; the same closures
        run again at each gang respawn (the launcher's hook changes what they
        read first: the coordinator's port, the resume checkpoint)."""
        with self._lock:
            self.generation += 1
        return [self.spawn(name, fn) for name, fn in spawners.items()]

    def finished(self) -> bool:
        """Every worker exited with rc 0: training is over."""
        with self._lock:
            return bool(self._replicas) and all(
                h.state == _STOPPED and h.last_rc == 0 for h in self._replicas.values()
            )

    def gang_info(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._gang_state, "generation": self.generation, "pod_restarts": self.pod_restarts,
                    "reason": self._gang_reason}

    # -- the engine --------------------------------------------------------------
    def _on_death(self, handle: ReplicaHandle, what: str, now: float) -> None:
        """A worker died, or was SIGKILLed as hung: park it and mark the gang
        dirty (never a respawn of it alone). ``rc == 0`` after no hang is a
        finished worker."""
        if self.stopping or handle.retired:
            handle.state = _STOPPED
            return
        if handle.last_rc == 0 and not what.startswith("hung"):
            handle.state = _STOPPED  # finished training; see finished()
            return
        handle.deaths += 1
        handle.last_error = what
        handle.state = _STOPPED  # parked until the gang respawns
        with self._lock:
            first = self._gang_reason is None
            if first:
                self._gang_reason = f"worker '{handle.name}' {what}"
        if first:
            warnings.warn(f"[{self.name}] worker '{handle.name}' {what} — a torch.distributed group cannot take a "
                          "respawned rank back: draining the survivors for a gang restart")

    def check(self) -> None:
        """One pass: procsup's detection, then the gang ladder. Raises
        :class:`WorkerAbortError` (``escalation=abort``) or
        :class:`AllWorkersDeadError` (``degrade`` past the budget)."""
        if self.stopping:
            return
        super().check()
        self._gang_ladder()

    def _gang_ladder(self) -> None:
        now = self._clock()
        with self._lock:
            reason, state = self._gang_reason, self._gang_state
        if reason is not None and state == _GANG_IDLE:
            self._drain_survivors()
            with self._lock:
                if self.escalation == "restart" or self.pod_restarts < self.max_restarts:
                    delay = self.backoff * (2.0 ** self.pod_restarts)
                    self._gang_state = _GANG_BACKOFF
                    self._gang_not_before = now + delay
                    warnings.warn(
                        f"[{self.name}] gang restart in {delay:g}s (pod restart {self.pod_restarts + 1}"
                        + ("" if self.escalation == "restart" else f"/{self.max_restarts}") + f"): {reason}"
                    )
                    return
                self._gang_state = _GANG_DEGRADED
                errors = {name: RuntimeError(h.last_error or reason) for name, h in self._replicas.items()}
                for h in self._replicas.values():
                    h.state = _DEGRADED
            if self.escalation == "abort":
                raise WorkerAbortError(self.name, RuntimeError(reason))
            warnings.warn(f"[{self.name}] pod restart budget ({self.max_restarts}) exhausted — a pod cannot train "
                          f"on part of its group, stopping: {reason}")
            raise AllWorkersDeadError(errors)
        if state == _GANG_BACKOFF and now >= self._gang_not_before:
            self._gang_respawn()

    def _drain_survivors(self) -> None:
        """SIGTERM the dirty generation's survivors, SIGKILL whoever is alive
        after ``drain_s``. Their exits are the generation's teardown, not new
        failures: nothing is counted."""
        with self._lock:
            survivors = [h for h in self._replicas.values() if h.state == _RUNNING and h.is_alive()]
            for h in survivors:
                h.state = _STOPPED  # claimed: detection must not read the exit again
        for h in survivors:
            try:
                h.proc.terminate()
            except OSError:
                pass
        deadline = self._clock() + self.drain_s
        for h in survivors:
            try:
                h.proc.wait(timeout=max(0.0, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                warnings.warn(f"[{self.name}] worker '{h.name}' did not drain within {self.drain_s:g}s — SIGKILL")
                try:
                    h.proc.kill()
                    h.proc.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            with self._lock:
                h.last_rc = h.proc.poll()

    def _gang_respawn(self) -> None:
        with self._lock:
            self.pod_restarts += 1
            self.generation += 1
            generation = self.generation
            self._gang_state = _GANG_IDLE
            self._gang_reason = None
            handles = list(self._replicas.values())
        if self.on_gang_restart is not None:
            try:
                self.on_gang_restart(generation)
            except Exception as e:  # the hook refused (a step fence): the gang stays down
                with self._lock:
                    self._gang_reason = f"on_gang_restart hook failed: {type(e).__name__}: {e}"
                warnings.warn(f"[{self.name}] {self._gang_reason}")
                return
        with self._lock:
            for handle in handles:
                if handle.retired:
                    continue
                handle.restarts += 1
                try:
                    self._launch(handle)
                except Exception as e:  # the spawn itself failed
                    handle.state = _STOPPED
                    handle.last_error = f"respawn failed: {type(e).__name__}: {e}"
                    if self._gang_reason is None:
                        self._gang_reason = f"worker '{handle.name}' {handle.last_error}"
                        warnings.warn(f"[{self.name}] {self._gang_reason}")
