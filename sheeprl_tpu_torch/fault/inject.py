"""Deterministic fault injection (counterpart of the part of
``sheeprl_tpu/fault/inject.py`` that training needs).

Probe points (:func:`fault_point`) sit in the checkpoint write
(``checkpoint.staged``, ``checkpoint.pre_commit``,
``checkpoint.post_commit``), the serving workers, the pipeline's queue
(``pipeline.queue.put``/``get``) and every step of a Sebulba actor
(``ppo_sebulba.actor{N}.step``, ``sac_sebulba.actor{N}.step``); tests arm
them in-process (:func:`arm`: raise :class:`FaultInjected`, SIGKILL the
process, kill the calling thread with :class:`ThreadKilled`, or stall it)
or across a process boundary with environment variables:

- ``SHEEPRL_FAULT_KILL="checkpoint.pre_commit:2"``: SIGKILL the process the
  2nd time ``checkpoint.pre_commit`` fires (comma-separate several points);
- ``SHEEPRL_FAULT_ARM="point:action:at[:hang_s]"``: arm points at start-up
  (:func:`arm_from_env`; :func:`arm_from_cfg` adds the seeded schedule of
  ``fault.chaos``, whose ``at`` may be a ``lo-hi`` range);
- ``SHEEPRL_FAULT_NAN_AT="2,5"``: the iterations whose training data
  :class:`NaNInjector` poisons, beside ``fault.inject.nan_grads_at``.

File corrupters (:func:`truncate_file`, :func:`scramble_file`,
:func:`plant_torn_checkpoint`) simulate torn and rotten saves;
:class:`FlakyEnv` is an env whose ``step``/``reset`` raises or hangs on a
shared fuse. Counters advance only for an armed point, so an unarmed probe
costs one dict lookup and one environment read.

Process-tier chaos: the serve fleet's router registers callables that
SIGKILL or SIGSTOP one of its replica processes (:func:`set_replica_chaos`),
the flywheel's learner supervisor the same for the learner process
(:func:`set_learner_chaos`), and the pod launcher for one of its training
workers (:func:`set_host_chaos`, at the points ``train.pod.tick`` and
``train.pod.step``); the ``kill-replica``/``hang-replica``,
``kill-learner``/``hang-learner`` and ``kill-host``/``hang-host`` actions
dispatch to them, from the point's calling thread, which carries on (an
unregistered handler is a no-op).
"""

from __future__ import annotations

import os
import signal
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FaultInjected",
    "ThreadKilled",
    "fault_point",
    "arm",
    "arm_from_env",
    "arm_from_cfg",
    "release_hangs",
    "disarm",
    "reset",
    "truncate_file",
    "scramble_file",
    "plant_torn_checkpoint",
    "NaNInjector",
    "FlakyEnv",
    "set_replica_chaos",
    "set_learner_chaos",
    "set_host_chaos",
    "KILL_ENV_VAR",
    "ARM_ENV_VAR",
    "NAN_ENV_VAR",
]

KILL_ENV_VAR = "SHEEPRL_FAULT_KILL"
ARM_ENV_VAR = "SHEEPRL_FAULT_ARM"
NAN_ENV_VAR = "SHEEPRL_FAULT_NAN_AT"

_ACTIONS = (
    "raise", "kill", "kill-thread", "hang",
    "kill-replica", "hang-replica", "kill-host", "hang-host", "kill-learner", "hang-learner",
)

_counts: Dict[str, int] = {}
_armed: Dict[str, Tuple[str, int, float]] = {}  # point -> (action, Nth hit, hang_s)
_hang_release = threading.Event()
# process-tier chaos: "kill"/"hang" callables registered by the fleet router
# (its replica processes), the flywheel's learner supervisor and the pod
# launcher (its training workers)
_replica_chaos: Dict[str, Optional[Callable[[], None]]] = {"kill": None, "hang": None}
_learner_chaos: Dict[str, Optional[Callable[[], None]]] = {"kill": None, "hang": None}
_host_chaos: Dict[str, Optional[Callable[[], None]]] = {"kill": None, "hang": None}


class FaultInjected(RuntimeError):
    """Raised by an in-process-armed fault point."""


class ThreadKilled(BaseException):
    """A thread killed by a ``kill-thread`` fault point. A ``BaseException``,
    so per-item recovery (``except Exception``) cannot swallow it: only the
    supervision layer (:class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor`)
    sees the thread die and heals it."""


def arm(point: str, action: str = "raise", at: int = 1, hang_s: float = 5.0) -> None:
    """Arm ``point`` to fire on its ``at``-th hit: ``raise``
    (:class:`FaultInjected`), ``kill`` (SIGKILL the process), ``kill-thread``
    (:class:`ThreadKilled`), ``hang`` (stall the calling thread ``hang_s``
    seconds, then return: a lease expiry, not a crash), or one of the
    process-tier actions (``kill-replica``, ``hang-replica``,
    ``kill-learner``, ``hang-learner``, ``kill-host``, ``hang-host``: call
    the registered handler)."""
    if action not in _ACTIONS:
        raise ValueError(f"Unknown fault action '{action}' (one of {_ACTIONS})")
    _armed[point] = (action, int(at), float(hang_s))
    _counts.pop(point, None)


def disarm(point: Optional[str] = None) -> None:
    if point is None:
        _armed.clear()
    else:
        _armed.pop(point, None)


def set_replica_chaos(kill: Optional[Callable[[], None]] = None, hang: Optional[Callable[[], None]] = None) -> None:
    """Register the fleet's handlers: ``kill()`` SIGKILLs one live replica
    process, ``hang()`` SIGSTOPs one (alive but silent: the lease-expiry
    model). ``kill-replica``/``hang-replica`` dispatch to them; cleared by
    :func:`reset`."""
    _replica_chaos["kill"], _replica_chaos["hang"] = kill, hang


def set_learner_chaos(kill: Optional[Callable[[], None]] = None, hang: Optional[Callable[[], None]] = None) -> None:
    """Register the flywheel learner's handlers (SIGKILL / SIGSTOP of the
    learner process); ``kill-learner``/``hang-learner`` dispatch to them;
    cleared by :func:`reset`."""
    _learner_chaos["kill"], _learner_chaos["hang"] = kill, hang


def set_host_chaos(kill: Optional[Callable[[], None]] = None, hang: Optional[Callable[[], None]] = None) -> None:
    """Register the pod launcher's handlers: ``kill()`` SIGKILLs one live
    training worker, ``hang()`` SIGSTOPs one (a dead host and a wedged one);
    ``kill-host``/``hang-host`` dispatch to them; cleared by :func:`reset`."""
    _host_chaos["kill"], _host_chaos["hang"] = kill, hang


def release_hangs() -> None:
    """Wake every thread stalled in a ``hang`` point (and any later one
    until the next :func:`reset`)."""
    _hang_release.set()


def reset() -> None:
    """Clear every armed point, hit counter and process-tier handler, and
    release stalled threads."""
    global _hang_release
    _armed.clear()
    _counts.clear()
    set_replica_chaos(None, None)
    set_learner_chaos(None, None)
    set_host_chaos(None, None)
    _hang_release.set()
    _hang_release = threading.Event()


def _parse_event(token: str, seed: int = 0) -> Optional[Tuple[str, str, int, float]]:
    """``"point:action:at[:hang_s]"`` -> (point, action, at, hang_s); ``at``
    may be ``"lo-hi"``, drawn from the ``(seed, point)`` pair, so adding an
    event never moves another's."""
    parts = [p.strip() for p in token.strip().split(":")]
    if not parts or not parts[0]:
        return None
    point = parts[0]
    action = parts[1] if len(parts) > 1 and parts[1] else "raise"
    at_raw = parts[2] if len(parts) > 2 and parts[2] else "1"
    hang_s = float(parts[3]) if len(parts) > 3 and parts[3] else 5.0
    if "-" in at_raw:
        lo, hi = (int(x) for x in at_raw.split("-", 1))
        at = int(np.random.default_rng([seed, *point.encode()]).integers(lo, hi + 1))
    else:
        at = int(at_raw)
    return point, action, at, hang_s


def arm_from_env() -> int:
    """Arm every event of ``SHEEPRL_FAULT_ARM``; returns how many."""
    armed = 0
    for token in os.environ.get(ARM_ENV_VAR, "").split(","):
        spec = _parse_event(token) if token.strip() else None
        if spec is not None:
            arm(spec[0], action=spec[1], at=spec[2], hang_s=spec[3])
            armed += 1
    return armed


def arm_from_cfg(cfg: Any) -> int:
    """Arm the seeded chaos schedule of ``cfg.fault.chaos`` (``enabled``,
    ``seed``, ``events``: ``"point:action:at[:hang_s]"`` tokens) and the
    events of ``SHEEPRL_FAULT_ARM``; returns how many points were armed."""
    armed = 0
    chaos = ((cfg.get("fault") or {}).get("chaos") or {}) if cfg is not None else {}
    if chaos.get("enabled", False):
        seed = int(chaos.get("seed", 0) or 0)
        for token in chaos.get("events") or ():
            spec = _parse_event(str(token), seed=seed)
            if spec is not None:
                arm(spec[0], action=spec[1], at=spec[2], hang_s=spec[3])
                armed += 1
    return armed + arm_from_env()


def _env_spec(point: str) -> Optional[Tuple[str, int, float]]:
    raw = os.environ.get(KILL_ENV_VAR, "")
    for token in raw.split(","):
        name, _, at = token.strip().partition(":")
        if name and name == point:
            return ("kill", int(at) if at else 1, 0.0)
    return None


def fault_point(point: str) -> None:
    """Probe: a no-op unless ``point`` is armed (in-process or through
    ``SHEEPRL_FAULT_KILL``)."""
    spec = _armed.get(point) or _env_spec(point)
    if spec is None:
        return
    action, at, hang_s = spec
    _counts[point] = _counts.get(point, 0) + 1
    if _counts[point] != at:
        return
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)  # the preemption model: no cleanup
    if action.endswith(("-replica", "-learner", "-host")):
        # process-tier chaos: the registered handler acts on another process;
        # the calling thread (the owner's poll loop) keeps running
        registry = {"replica": _replica_chaos, "learner": _learner_chaos, "host": _host_chaos}[action.split("-", 1)[1]]
        handler = registry[action.split("-", 1)[0]]
        if handler is not None:
            handler()
        return
    if action == "hang":
        # stall, then return: the woken thread must notice its own verdict (ctx.cancelled)
        _hang_release.wait(hang_s)
        return
    if action == "kill-thread":
        raise ThreadKilled(f"thread killed at '{point}' (hit {at})")
    raise FaultInjected(f"fault injected at '{point}' (hit {at})")


# -- file corrupters ---------------------------------------------------------
def truncate_file(path: "str | os.PathLike", keep_bytes: int = 8) -> None:
    """Truncate ``path`` to ``keep_bytes``: a torn write."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def scramble_file(path: "str | os.PathLike", seed: int = 0) -> None:
    """Overwrite ``path`` with deterministic garbage of the same size."""
    size = max(1, os.path.getsize(path))
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())


def _rot_pickle_record(path: Path, seed: int) -> None:
    """Scramble the bytes of the checkpoint's pickle record in place, leaving
    the zip container (and so the cheap completeness probe) intact."""
    with zipfile.ZipFile(path) as zf:
        info = next((i for i in zf.infolist() if i.filename.endswith("data.pkl")), None)
        if info is None:
            raise RuntimeError(f"{path} is not a torch.save zip archive with a data.pkl record")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = np.frombuffer(f.read(4), dtype="<u2")
        f.seek(info.header_offset + 30 + int(name_len) + int(extra_len))
        rng = np.random.default_rng(seed)
        f.write(rng.integers(0, 256, size=info.compress_size, dtype=np.uint8).tobytes())


def plant_torn_checkpoint(
    ckpt_dir: "str | os.PathLike", name: str, state: Any, step: Optional[int] = None, seed: int = 0
) -> Path:
    """Install a manifest-published checkpoint that is already rotten: the
    manifest says it is complete and its digest and size match, but
    :func:`~sheeprl_tpu_torch.utils.checkpoint.load_checkpoint` fails. The
    file is written and rotted beside the directory and renamed in, so a
    reader never sees a loadable intermediate. Returns the installed path."""
    import tempfile

    from sheeprl_tpu_torch.fault import manager as _manager
    from sheeprl_tpu_torch.utils.checkpoint import write_host_checkpoint

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if step is None:
        step = _manager.parse_step(name) or 0
    with tempfile.TemporaryDirectory(dir=ckpt_dir.parent, prefix="torn_staging_") as staging:
        staged = Path(staging) / name
        write_host_checkpoint(staged, dict(state))
        _rot_pickle_record(staged, seed)
        target = ckpt_dir / name
        os.replace(staged, target)
    entries = [e for e in _manager.read_manifest(ckpt_dir) if e.get("file") != name]
    entries.append(_manager.manifest_entry(target, int(step)))
    entries.sort(key=lambda e: (int(e.get("step", 0)), float(e.get("time", 0.0))))
    _manager.write_manifest(ckpt_dir, entries)
    return target


# -- NaN injection -----------------------------------------------------------
class NaNInjector:
    """Poison a training-data key with NaNs at chosen iterations, from
    ``cfg.fault.inject.nan_grads_at`` and ``SHEEPRL_FAULT_NAN_AT`` ("2,5"):
    the poisoned key (PPO: ``advantages``) flows into the loss and the
    gradients, as one bad batch would."""

    def __init__(self, cfg: Optional[Any] = None, at: Sequence[int] = ()) -> None:
        iters: List[int] = [int(i) for i in at]
        if cfg is not None:
            inject_cfg = (cfg.get("fault") or {}).get("inject") or {}
            iters += [int(i) for i in (inject_cfg.get("nan_grads_at") or ())]
        raw = os.environ.get(NAN_ENV_VAR, "")
        iters += [int(t) for t in raw.split(",") if t.strip()]
        self.at = frozenset(iters)
        self.fired = 0

    def __bool__(self) -> bool:
        return bool(self.at)

    def fires(self, iter_num: int) -> bool:
        return int(iter_num) in self.at

    def poison(self, data: Dict[str, Any], key: str, iter_num: int) -> Dict[str, Any]:
        """``data[key]`` replaced by NaNs of its shape (and, for a tensor, its
        dtype and device) at a poisoned iteration."""
        if self.fires(iter_num):
            value = data[key]
            if hasattr(value, "new_full"):  # a tensor stays where it was
                data[key] = value.new_full(value.shape, float("nan"))
            else:
                data[key] = np.full(np.shape(value), np.nan, dtype=np.float32)
            self.fired += 1
        return data


# -- flaky / hanging envs ----------------------------------------------------
class FlakyEnv:
    """An env wrapper whose ``step``/``reset`` raises or hangs on schedule.

    ``fuse`` is a shared mutable list holding the failures left: pass the
    same list to every instance a factory builds, so a recreated env does
    not fail again at once. ``mode`` is ``"raise"`` or ``"hang"`` (sleeps
    ``hang_seconds`` to trip a watchdog, then raises)."""

    def __init__(self, env: Any, fuse: List[int], fail_on: str = "step", mode: str = "raise",
                 hang_seconds: float = 60.0) -> None:
        self.env = env
        self._fuse = fuse
        self._fail_on = fail_on
        self._mode = mode
        self._hang_seconds = hang_seconds

    def __getattr__(self, name: str) -> Any:
        return getattr(self.env, name)

    def _maybe_fail(self, phase: str) -> None:
        if phase == self._fail_on and self._fuse and self._fuse[0] > 0:
            self._fuse[0] -= 1
            if self._mode == "hang":
                time.sleep(self._hang_seconds)
            raise RuntimeError(f"FlakyEnv: injected {phase} failure")

    def step(self, action):
        self._maybe_fail("step")
        return self.env.step(action)

    def reset(self, *, seed=None, options=None):
        self._maybe_fail("reset")
        return self.env.reset(seed=seed, options=options)

    def close(self) -> None:
        self.env.close()
