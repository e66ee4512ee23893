"""Versioned hot-swappable serving weights (counterpart of
``sheeprl_tpu/serve/weights.py``): :class:`WeightStore` and
:class:`CheckpointWatcher`.

Newest wins: the scheduler pulls one ``(version, params)`` snapshot per
batch and serves every row of the batch under it, so a swap never tears a
request. A published params object is never changed afterwards; a swap
publishes a new one, built from the checkpoint into fresh tensors (never a
``load_state_dict`` into the live ones).

:class:`CheckpointWatcher` feeds a store from a run's ``checkpoint/``
directory: it polls the manager's ``manifest.json`` through
:func:`~sheeprl_tpu_torch.fault.manager.complete_entries` (only complete,
digest-checked saves), and publishes each save with a step newer than the
last one published. The manifest's digest cannot tell a file that rotted
after it was published: such a save fails only when it loads. Each failure
is counted (``Serve/watcher_errors``) and struck against its path; after
``quarantine_after`` strikes the path is quarantined, and the watcher
serves the last good weights until a newer save appears.
"""

from __future__ import annotations

import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Set, Tuple

import torch

from sheeprl_tpu_torch.fault.inject import fault_point

__all__ = ["WeightStore", "CheckpointWatcher"]


def _cuda_devices(params: Any) -> Iterator[torch.device]:
    if isinstance(params, torch.Tensor):
        if params.is_cuda:
            yield params.device
    elif isinstance(params, torch.nn.Module):
        for t in params.state_dict().values():
            yield from _cuda_devices(t)
    elif isinstance(params, dict):
        for v in params.values():
            yield from _cuda_devices(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _cuda_devices(v)


class WeightStore:
    """``params_from_state`` (the policy's ``params_from_state``) turns a
    checkpoint state into servable params for :meth:`publish_state`;
    :meth:`publish_params` takes params that are already built. ``stats``
    (a :class:`~sheeprl_tpu_torch.serve.scheduler.ServeStats`) counts the
    publishes and pulls."""

    def __init__(self, params: Any, params_from_state: Optional[Callable[[Any], Any]] = None,
                 stats: Any = None) -> None:
        self._lock = threading.Lock()
        self._params = params
        self._version = 0  # the construction-time params; publishes are >= 1
        self._params_from_state = params_from_state
        self._published_at = time.monotonic()
        self.stats = stats

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def staleness_s(self) -> float:
        """Seconds since the last publish (construction counts as one)."""
        with self._lock:
            return max(0.0, time.monotonic() - self._published_at)

    def pull(self) -> Tuple[int, Any]:
        with self._lock:
            out = self._version, self._params
        if self.stats is not None:
            self.stats.add("pulls", 1)
        return out

    def publish_params(self, params: Any) -> int:
        """Make ``params`` the newest version. Their tensors must be
        complete: a dispatch may read them as soon as this returns."""
        with self._lock:
            self._params = params
            self._version += 1
            self._published_at = time.monotonic()
            version = self._version
        if self.stats is not None:
            self.stats.add("publishes", 1)
        return version

    def publish_state(self, state: Any) -> int:
        """Build params from a checkpoint state and publish them. The build
        copies the weights to the card on the calling thread's current
        stream, the device's default stream (the watcher sets no other);
        that stream is synchronised before the publish, so no dispatch can
        pull params whose copies are still in flight."""
        if self._params_from_state is None:
            raise RuntimeError("this WeightStore was built without a params_from_state converter")
        params = self._params_from_state(state)
        for device in set(_cuda_devices(params)):
            torch.cuda.current_stream(device).synchronize()
        return self.publish_params(params)


class CheckpointWatcher:
    """Publishes a run's new complete checkpoints into a store, from a
    background thread (supervised with ``start(supervisor=...)``): a new
    complete manifest entry with a strictly newer step is loaded and its
    state published. A load failure is warned, counted
    (``stats.watcher_errors``) and struck against the path; the
    ``quarantine_after``-th strike quarantines it."""

    def __init__(self, ckpt_dir: "str | Path", store: WeightStore, poll_s: float = 2.0, stats: Any = None,
                 quarantine_after: int = 3) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        self.store = store
        self.poll_s = float(poll_s)
        self.stats = stats
        self.quarantine_after = max(1, int(quarantine_after))
        self._last: Optional[Path] = None
        self._last_step = -1
        self._strikes: Dict[Path, int] = {}
        self.quarantined: Set[Path] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = threading.Thread(target=self._run, name="serve-ckpt-watcher",
                                                                     daemon=True)
        self._handle = None  # the supervisor's WorkerHandle when supervised
        self.published = 0
        #: (step, version, wall-clock time.time() of the publish) of every publish
        self.history = []

    @property
    def last_step(self) -> int:
        """The step of the last save published (-1: none yet)."""
        return self._last_step

    def start(self, publish_current: bool = False, supervisor: Any = None) -> "CheckpointWatcher":
        """Begin watching. With ``publish_current`` the newest complete save
        is published at once; by default only newer saves swap in (the
        server was built from a checkpoint already). With ``supervisor`` the
        poll loop runs supervised: a thread-killing failure restarts it."""
        if not publish_current:
            self._prime()
        if supervisor is None:
            self._thread.start()
        else:
            self._thread = None
            self._handle = supervisor.spawn("serve-ckpt-watcher", self._run, lease_s=None)
        return self

    def alive(self) -> bool:
        """Is the poll loop live (health probes)?"""
        if self._handle is not None:
            return self._handle.live()
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._handle is not None:
            self._handle.retire()  # no respawn racing this stop
        thread = self._handle.thread if self._handle is not None else self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)

    def poll_once(self) -> bool:
        """One sweep of the manifest; True when a new save was published."""
        from sheeprl_tpu_torch.fault.manager import complete_entries
        from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

        fault_point("serve.watcher.poll")
        # newest first, quarantined paths skipped: the candidate is the first
        # other entry strictly newer than the last publish
        for _t, step, path in reversed(complete_entries(self.ckpt_dir)):
            if path in self.quarantined:
                continue
            if path == self._last or step <= self._last_step:
                return False
            try:
                # publish inside the strike scope: a save that loads but
                # cannot be built into params strikes too
                version = self.store.publish_state(load_checkpoint(path))
            except Exception as e:
                self._strike(path, e)
                return False
            self._last, self._last_step = path, step
            self.published += 1
            self.history.append((int(step), int(version), time.time()))
            return True
        return False

    def _count_error(self) -> None:
        if self.stats is not None:
            self.stats.add("watcher_errors", 1)

    def _strike(self, path: Path, error: BaseException) -> None:
        """Count a load failure against ``path``; quarantine past the budget.
        The warning comes before the state a poller reads, so a poller that
        sees the state knows the warning was given."""
        strikes = self._strikes.get(path, 0) + 1
        if strikes >= self.quarantine_after:
            warnings.warn(
                f"serve checkpoint watcher QUARANTINED {path} after {strikes} failed loads "
                f"({type(error).__name__}: {error}); serving continues on the previous weights"
            )
            self.quarantined.add(path)
        else:
            warnings.warn(
                f"serve checkpoint watcher could not load {path} (strike {strikes}/{self.quarantine_after}): {error}"
            )
        self._strikes[path] = strikes
        self._count_error()

    def _prime(self) -> None:
        from sheeprl_tpu_torch.fault.manager import complete_entries

        entries = complete_entries(self.ckpt_dir)
        if entries:
            _t, step, path = entries[-1]
            self._last, self._last_step = path, step

    def _run(self, ctx: Any = None) -> None:
        while not self._stop.is_set():
            if ctx is not None:
                ctx.beat()
            try:
                self.poll_once()
            except Exception as e:  # a poll failure never stops serving
                warnings.warn(f"serve checkpoint watcher error: {e}")
                self._count_error()
            self._stop.wait(self.poll_s)
        if ctx is not None:
            ctx.retire()  # an owner-driven stop: expected, not a crash to restart
