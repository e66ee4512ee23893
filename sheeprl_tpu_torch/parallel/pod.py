"""Pod training: N worker processes over one ``torch.distributed`` group,
under gang supervision (counterpart of ``sheeprl_tpu/parallel/pod.py``).

``python -m sheeprl_tpu_torch run --pod N ...`` (or ``fabric.pod.workers=N``)
spawns N workers that each join the group through
:func:`~sheeprl_tpu_torch.parallel.distributed.maybe_init` and run the
ordinary training entry point, one device each: every worker steps its own
envs and reduces its gradients with the others' before each optimizer step.
On a one-card machine all workers share the card.

The launcher itself touches no device. It is a process manager over
:class:`~sheeprl_tpu_torch.fault.podsup.PodSupervisor`:

- **Liveness is heartbeat files.** Each worker runs a daemon thread that
  touches ``$SHEEPRL_POD_HEARTBEAT`` every ``beat_s``, and its training loop
  writes the completed global step into it each iteration
  (:func:`beat_step`). The launcher polls the mtimes into
  :meth:`PodSupervisor.beat`; a SIGSTOPped or wedged worker stops touching
  and is SIGKILLed at its lease's end, counted as a hang, apart from a
  SIGKILL from outside (a kill).
- **Recovery is a gang restart with a step fence.** On an abnormal death
  the supervisor drains the survivors and calls
  :meth:`PodLauncher._on_gang_restart`: a fresh coordinator port (the dead
  rank 0 may still hold the old one), the newest complete checkpoint pinned
  as ``checkpoint.resume_from`` (a fresh start when there is none), and the
  resumed step fenced: each restart's step must be at least the previous
  fence, else :class:`StepFenceError`, so no step is counted twice. The
  counters come back from the checkpoint, so a killed run ends on its
  fault-free twin's counters.
- **SIGTERM drains from the outside in.** The launcher stops supervising and
  SIGTERMs the workers; each checkpoints at its next iteration boundary and
  exits 0 (:func:`drain_requested`), and the launcher exits 0.
- **Chaos drills.** ``kill-host`` / ``hang-host`` armed from
  ``fault.chaos.events`` fire at the launcher's points and SIGKILL / SIGSTOP
  a live worker: ``train.pod.tick`` counts supervision ticks, and
  ``train.pod.step`` counts heartbeat step advances (one per worker and
  iteration), which land at the same training moment however fast a run is.

The coordinator's port is picked below the kernel's ephemeral range
(:func:`~sheeprl_tpu_torch.serve.fleet.free_port`): rank 0 binds it seconds
after the pick, and an outgoing connection may take a port of the
ephemeral range meanwhile.

The worker side (heartbeat thread, SIGTERM drain flag, step beats) lives
here too and is active only under ``SHEEPRL_POD_RANK``; ``cli.run`` starts it
for every training entry point.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.podsup import PodSupervisor
from sheeprl_tpu_torch.serve.fleet import free_port

__all__ = [
    "PodLauncher",
    "StepFenceError",
    "run_pod",
    "pod_worker_active",
    "maybe_start_worker_runtime",
    "drain_requested",
    "beat_step",
]

COORDINATOR_ENV = "SHEEPRL_COORDINATOR"
NUM_PROCESSES_ENV = "SHEEPRL_NUM_PROCESSES"
PROCESS_ID_ENV = "SHEEPRL_PROCESS_ID"
RANK_ENV = "SHEEPRL_POD_RANK"
HEARTBEAT_ENV = "SHEEPRL_POD_HEARTBEAT"
BEAT_S_ENV = "SHEEPRL_POD_BEAT_S"

TICK_POINT = "train.pod.tick"
STEP_POINT = "train.pod.step"


class StepFenceError(RuntimeError):
    """A gang restart resolved a resume checkpoint BEHIND the previous
    generation's fence: resuming from it would train steps twice."""


# -- the worker side: heartbeat and drain (active only under SHEEPRL_POD_RANK) --

_drain_event = threading.Event()
_worker_started = False
_hb_path: Optional[str] = None


def pod_worker_active() -> bool:
    """True in a process the pod launcher spawned."""
    return RANK_ENV in os.environ


def drain_requested() -> bool:
    """True once the launcher SIGTERMed this worker: the training loop
    checkpoints at its next iteration boundary and exits 0."""
    return _drain_event.is_set()


def beat_step(step: int) -> None:
    """Write the completed global step into the heartbeat file: the mtime
    renews the lease, and a change of content is the launcher's sign of the
    first step after a restart (the end of the MTTR window). A no-op outside
    a pod worker."""
    if _hb_path is None:
        return
    tmp = _hb_path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(int(step)))
        os.replace(tmp, _hb_path)
    except OSError:
        pass


def maybe_start_worker_runtime() -> bool:
    """Under the launcher: start a daemon thread touching
    ``$SHEEPRL_POD_HEARTBEAT`` every ``$SHEEPRL_POD_BEAT_S`` seconds, and a
    SIGTERM handler raising the drain flag. Idempotent; returns whether the
    runtime is active. It starts before the group is joined, so the lease
    survives a slow start."""
    global _worker_started, _hb_path
    if not pod_worker_active():
        return False
    if _worker_started:
        return True
    _worker_started = True
    _hb_path = os.environ.get(HEARTBEAT_ENV) or None
    if _hb_path is not None:
        beat_s = max(0.05, float(os.environ.get(BEAT_S_ENV, "0.5") or 0.5))
        hb_path = _hb_path

        def _beat_loop() -> None:
            while not _drain_event.wait(beat_s):
                try:
                    os.utime(hb_path)
                except OSError:
                    try:
                        Path(hb_path).touch()
                    except OSError:
                        pass

        # unsupervised on purpose: the heartbeat is what the launcher watches
        threading.Thread(target=_beat_loop, name="pod-heartbeat", daemon=True).start()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: _drain_event.set())
    except (ValueError, OSError):  # not the main thread
        pass
    return True


# -- the launcher ----------------------------------------------------------------


class PodLauncher:
    """A gang-supervised pod of N training workers (see the module
    docstring). ``argv`` is the user's override list without the ``--pod``
    flag; each worker composes its config from it and the launcher's pins."""

    def __init__(self, cfg: Any, argv: List[str]) -> None:
        pod_cfg = dict((cfg.get("fabric") or {}).get("pod") or {})
        self.workers = int(pod_cfg.get("workers", 0) or 0)
        if self.workers < 2:
            raise ValueError(f"pod training needs fabric.pod.workers >= 2, got {self.workers} — "
                             "drop the --pod flag for a single-process run")
        dpw = int(pod_cfg.get("devices_per_worker") or 1)
        if dpw > 1:
            raise NotImplementedError(
                f"fabric.pod.devices_per_worker={dpw}: the port drives one device per process, so a pod worker "
                f"holds one device; for {self.workers * dpw} devices run `--pod {self.workers * dpw}`"
            )
        self.cfg = cfg
        self.pod_cfg = pod_cfg
        self.argv = [a for a in argv if not a.startswith("checkpoint.resume_from=")]
        self.user_resume = next((a.split("=", 1)[1] for a in argv if a.startswith("checkpoint.resume_from=")), None)
        self.host = str(pod_cfg.get("coordinator_host", "127.0.0.1") or "127.0.0.1")
        self.beat_s = float(pod_cfg.get("beat_s") or max(0.1, float(pod_cfg.get("lease_s", 30.0) or 30.0) / 4.0))
        self.tick_s = max(0.02, float(pod_cfg.get("tick_s", 0.25) or 0.25))
        self.join_s = float(pod_cfg.get("join_s", 30.0) or 30.0)
        self.dir = Path(tempfile.mkdtemp(prefix="sheeprl-pod-"))
        # the experiment's checkpoint root, as cli.resolve_resume_latest reads it
        self.ckpt_root = Path(str(cfg.get("log_root", "logs/runs"))) / str(cfg.get("root_dir"))
        self.sup = PodSupervisor.from_config(
            pod_cfg, name="train-pod", lease_s=30.0, grace_s=120.0, max_restarts=2, backoff=0.5,
            escalation="degrade", join_s=self.join_s,
        )
        self.sup.on_gang_restart = self._on_gang_restart
        # the launch context the spawn closures read; a gang restart changes it first
        self._port = free_port(self.host)
        self._resume: Optional[str] = self.user_resume
        self.fences: List[int] = []
        self._hb_paths = {rank: self.dir / f"heartbeat_{rank}" for rank in range(self.workers)}
        self._hb_mtime: Dict[int, float] = {}
        self._hb_content: Dict[int, str] = {}
        self._fault_t: Optional[float] = None  # when chaos struck
        self._pending_restart: Optional[Dict[str, Any]] = None
        self.restart_log: List[Dict[str, Any]] = []

    # -- the workers ---------------------------------------------------------------
    def worker_command(self, rank: int) -> List[str]:
        cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", *self.argv]
        cmd.append("fabric.pod.workers=0")  # a worker never starts a pod of its own
        if self._resume:
            cmd.append(f"checkpoint.resume_from={self._resume}")
        return cmd

    def worker_env(self, rank: int) -> Dict[str, str]:
        env = dict(os.environ)
        env[COORDINATOR_ENV] = f"{self.host}:{self._port}"
        env[NUM_PROCESSES_ENV] = str(self.workers)
        env[PROCESS_ID_ENV] = str(rank)
        env[RANK_ENV] = str(rank)
        env[HEARTBEAT_ENV] = str(self._hb_paths[rank])
        env[BEAT_S_ENV] = str(self.beat_s)
        if "OMP_NUM_THREADS" not in env:
            # the workers share the host's cores: torch's default of one
            # thread per core in each worker oversubscribes them, and each
            # worker's threads then wait on cores the other holds
            env["OMP_NUM_THREADS"] = str(max(1, len(os.sched_getaffinity(0)) // self.workers))
        return env

    def _spawner(self, rank: int) -> Callable[[], subprocess.Popen]:
        def spawn() -> subprocess.Popen:
            hb = self._hb_paths[rank]
            # emptied, not only touched: a resumed generation may reach the
            # last step again, and the first-step sign is a change of content
            hb.write_text("", encoding="utf-8")
            self._hb_mtime[rank] = hb.stat().st_mtime
            self._hb_content[rank] = ""
            return subprocess.Popen(self.worker_command(rank), env=self.worker_env(rank))

        return spawn

    # -- a gang restart: fresh port, resume checkpoint, step fence --------------
    def _on_gang_restart(self, generation: int) -> None:
        from sheeprl_tpu_torch.fault.manager import find_latest_run_checkpoint, parse_step

        self._port = free_port(self.host)
        resolved = find_latest_run_checkpoint(self.ckpt_root)
        if resolved is None:  # nothing committed yet: the gang starts over
            self._resume = self.user_resume
            step = 0
        else:
            self._resume = str(resolved)
            step = parse_step(Path(resolved).name) or 0
        if self.fences and step < self.fences[-1]:
            raise StepFenceError(
                f"gang restart (generation {generation}) resolved resume checkpoint '{resolved}' at step {step}, "
                f"BEHIND the previous fence {self.fences[-1]} — refusing to double-count steps"
            )
        self.fences.append(step)
        self._pending_restart = {"generation": generation, "resume": self._resume, "fence": step,
                                 "fault_t": self._fault_t, "respawn_t": time.monotonic()}
        self._fault_t = None
        print(f"pod: gang restart (generation {generation}) on coordinator port {self._port}"
              + (f", resume_from={self._resume} (fence step {step})" if self._resume else ", fresh start"), flush=True)

    # -- chaos (kill-host / hang-host) ---------------------------------------------
    def _live_victim(self):
        for h in self.sup.replicas():
            if h.state == "running" and h.is_alive():
                return h
        return None

    def _chaos(self, sig: int, action: str) -> None:
        h = self._live_victim()
        if h is None:
            return
        self._fault_t = time.monotonic()
        print(f"pod: chaos {action} -> {signal.Signals(sig).name} worker '{h.name}' (pid {h.pid()})", flush=True)
        try:
            os.kill(h.pid(), sig)
        except OSError:
            pass

    def _chaos_kill(self) -> None:
        self._chaos(signal.SIGKILL, "kill-host")

    def _chaos_hang(self) -> None:
        self._chaos(signal.SIGSTOP, "hang-host")

    # -- heartbeats --------------------------------------------------------------
    def _poll_heartbeats(self) -> None:
        for rank, path in self._hb_paths.items():
            try:
                st = path.stat()
                content = path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            if st.st_mtime > self._hb_mtime.get(rank, 0.0):
                self._hb_mtime[rank] = st.st_mtime
                self.sup.beat(f"worker-{rank}")
            if content and content != self._hb_content.get(rank, ""):
                if self._pending_restart is not None:
                    # the first completed iteration after a restart closes the MTTR window
                    rec, self._pending_restart = self._pending_restart, None
                    now = time.monotonic()
                    rec["first_step_t"] = now
                    rec["mttr_s"] = now - (rec.get("fault_t") or rec["respawn_t"])
                    self.restart_log.append(rec)
                    print(f"pod: first post-restart train step (generation {rec['generation']}) — MTTR "
                          f"{rec['mttr_s']:.3f}s", flush=True)
                self._hb_content[rank] = content
                inject.fault_point(STEP_POINT)

    # -- the run -------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        inject.arm_from_cfg(self.cfg)
        inject.set_host_chaos(kill=self._chaos_kill, hang=self._chaos_hang)
        drain = threading.Event()
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, lambda *_: drain.set())
            except (ValueError, OSError):  # not the main thread
                pass
        print(f"pod: launching {self.workers} workers on coordinator {self.host}:{self._port}", flush=True)
        self.fences.append(0)
        error: Optional[BaseException] = None
        try:
            self.sup.spawn_gang({f"worker-{rank}": self._spawner(rank) for rank in range(self.workers)})
            while not drain.is_set():
                drain.wait(self.tick_s)
                inject.fault_point(TICK_POINT)
                self._poll_heartbeats()
                self.sup.check()
                if self.sup.finished():
                    break
        except BaseException as e:  # the supervisor's typed errors included
            error = e
        finally:
            for sig, handler in prev_handlers.items():
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass
            drained = drain.is_set()
            if drained:
                print("pod: drain requested — terminating workers (checkpoint-and-exit)", flush=True)
            self.sup.terminate_all(grace_s=self.join_s)  # every worker reaped, whatever happened
            inject.set_host_chaos()
            shutil.rmtree(self.dir, ignore_errors=True)
        summary = self.summary(drained=drained, error=error)
        print("POD_SUMMARY " + json.dumps(summary), flush=True)
        if error is not None:
            raise error
        return summary

    def summary(self, drained: bool, error: Optional[BaseException]) -> Dict[str, Any]:
        snap = self.sup.snapshot()
        return {
            "workers": self.workers,
            "generation": self.sup.generation,
            "pod_restarts": self.sup.pod_restarts,
            "finished": self.sup.finished(),
            "drained": drained,
            "error": f"{type(error).__name__}: {error}" if error is not None else None,
            "fences": self.fences,
            "kills": sum(h["kills"] for h in snap.values()),
            "hangs": sum(h["hangs"] for h in snap.values()),
            "deaths": sum(h["deaths"] for h in snap.values()),
            "restarts": [{k: v for k, v in rec.items() if k in ("generation", "fence", "mttr_s")}
                         for rec in self.restart_log],
            "workers_detail": snap,
        }


def run_pod(cfg: Any, argv: List[str]) -> Dict[str, Any]:
    """``run --pod N``'s body (see :class:`PodLauncher`)."""
    return PodLauncher(cfg, argv).run()
