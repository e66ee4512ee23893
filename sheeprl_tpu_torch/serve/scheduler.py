"""Micro-batching request scheduler (counterpart of
``sheeprl_tpu/serve/scheduler.py``).

Requests (one prepared observation row per session request, or ``n >= 1``
one-shot rows) enter a bounded queue; one worker thread runs the admission
loop:

- the first request opens a batch and arms a max-wait deadline;
- further requests join until the batch would exceed ``max_batch`` rows, a
  second request for a session already in the batch arrives (it is held
  over, never reordered: one batch steps a session at most once), or the
  deadline passes;
- the batch is one engine dispatch under one pulled weight snapshot, and
  every caller's future resolves with its own action rows and the weight
  version that produced them.

With a :class:`~sheeprl_tpu_torch.serve.sessions.SessionEngine` the batch
steps session state rows; with a stateless engine
(:class:`~sheeprl_tpu_torch.serve.engine.BucketEngine` or
:class:`~sheeprl_tpu_torch.serve.engine.NaiveEngine`, which have no session
``cache``) it is one ``infer`` over the concatenated rows, and in sample mode
batch ``i`` is keyed ``(seed, i)``, the counterpart of the JAX scheduler's
``fold_in(base_key, i)``.

Past the queue bound ``submit`` blocks (backpressure) and raises
:class:`ServeOverloadedError` once its timeout expires. With the flywheel on
(:attr:`RequestScheduler.flywheel`, a
:class:`~sheeprl_tpu_torch.serve.flywheel.TrajectoryLog`) each resolved
request, with its optional ``reward``/``done`` feedback and its stream, is
observed after its caller is released: the log never adds to a request's
latency and never fails it. The worker thread
runs inference, so it binds the engine's CUDA device when it starts; it uses
that device's current stream, like every other caller.

The worker can run supervised (``start(supervisor=...)``, a
:class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor`): a crash mid-batch
kills only that worker generation, and the supervisor's restart hook
(:meth:`RequestScheduler.recover_inflight`) hands the batch it had admitted
to the next generation, which serves it first: no admitted request is
dropped.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.fault.inject import fault_point

__all__ = [
    "ServeStats",
    "RequestScheduler",
    "ServeOverloadedError",
    "ServeClosedError",
    "ServeTimeoutError",
]


class ServeOverloadedError(RuntimeError):
    """The request queue stayed at its bound past the submit timeout."""


class ServeClosedError(RuntimeError):
    """submit() after the scheduler stopped."""


class ServeTimeoutError(TimeoutError):
    """A submitted request did not resolve inside the caller's timeout."""


class ServeStats:
    """The serving tier's ``Serve/*`` counters and gauges."""

    def __init__(self, latency_window: int = 4096) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.rows_served = 0
        self.batches = 0
        self.rejected = 0
        self.swaps = 0
        self.weight_version = 0
        self.watcher_errors = 0  # checkpoint-watcher load and poll failures
        self.weights_stale = 0  # ok -> stale transitions of the staleness alarm
        self.publishes = 0  # weight versions published into the store
        self.pulls = 0  # weight snapshots pulled by dispatches
        self.max_queue_depth = 0
        self._latencies = collections.deque(maxlen=int(latency_window))
        self._depth_fn = None  # wired by the scheduler
        self._sessions_fn = None  # wired by the scheduler
        self._flywheel_fn = None  # wired when the flywheel is on

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + value)

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self.max_queue_depth = max(self.max_queue_depth, int(depth))

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    def observe_version(self, version: int) -> None:
        with self._lock:
            if version > self.weight_version:
                self.swaps += version - self.weight_version
                self.weight_version = version

    def latency_percentiles(self) -> Tuple[float, float]:
        """(p50, p99) in seconds over the sliding window (0.0, 0.0 empty)."""
        with self._lock:
            lat = list(self._latencies)
        if not lat:
            return 0.0, 0.0
        arr = np.asarray(lat)
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))

    def snapshot(self) -> Dict[str, float]:
        p50, p99 = self.latency_percentiles()
        depth = self._depth_fn() if self._depth_fn is not None else 0
        with self._lock:
            rows, batches = self.rows_served, self.batches
            out = {
                "Serve/requests": self.requests,
                "Serve/rows": rows,
                "Serve/batches": batches,
                "Serve/rows_per_batch": round(rows / batches, 2) if batches else 0.0,
                "Serve/rejected": self.rejected,
                "Serve/queue_depth": depth,
                "Serve/max_queue_depth": self.max_queue_depth,
                "Serve/weight_version": self.weight_version,
                "Serve/swap_count": self.swaps,
                "Serve/watcher_errors": self.watcher_errors,
                "Serve/weights_stale": self.weights_stale,
                "Serve/p50_latency_ms": round(p50 * 1e3, 3),
                "Serve/p99_latency_ms": round(p99 * 1e3, 3),
            }
            sessions_fn = self._sessions_fn
            flywheel_fn = self._flywheel_fn
        if flywheel_fn is not None:
            fl = flywheel_fn()
            out.update(
                {
                    "Serve/flywheel_rows": fl["rows_logged"],
                    "Serve/flywheel_shed": fl["rows_shed"],
                    "Serve/flywheel_feedback_missing": fl["feedback_missing"],
                    "Serve/flywheel_feedback_orphans": fl["feedback_orphans"],
                    "Serve/flywheel_depth": fl["transport_depth"],
                    "Serve/flywheel_spooled": fl["rows_spooled"],
                    "Serve/flywheel_errors": fl["errors"],
                }
            )
        if sessions_fn is not None:
            s = sessions_fn()
            out.update(
                {
                    "Serve/sessions_live": s["live"],
                    "Serve/sessions_peak": s["peak"],
                    "Serve/sessions_opened": s["opened"],
                    "Serve/sessions_evicted": s["evicted_lru"] + s["evicted_ttl"],
                    "Serve/sessions_ttl_evicted": s["evicted_ttl"],
                    "Serve/sessions_reset": s["resets"],
                    "Serve/sessions_client_resets": s["client_resets"],
                    "Serve/sessions_state_bytes": s["state_bytes"],
                }
            )
        return out


class _Request:
    __slots__ = ("obs", "n", "session_id", "reset", "reward", "done", "stream", "event", "actions", "version", "error",
                 "t_submit", "t_resolve")

    def __init__(self, obs: Dict[str, np.ndarray], n: int, session_id: Optional[str] = None, reset: bool = False,
                 reward: Any = None, done: Any = None, stream: Optional[str] = None):
        self.obs = obs
        self.n = n
        self.session_id = session_id
        self.reset = bool(reset)
        # the flywheel's feedback: it grades the PREVIOUS action served on
        # this stream (a session, a connection or an in-process client)
        self.reward = reward
        self.done = done
        self.stream = stream
        self.event = threading.Event()
        self.actions: Optional[np.ndarray] = None
        self.version = -1
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_resolve = 0.0

    @property
    def latency_s(self) -> float:
        """Submit -> resolve seconds, stamped by the worker."""
        return max(0.0, self.t_resolve - self.t_submit)

    def resolve(self, actions: Optional[np.ndarray], version: int, error: Optional[BaseException] = None) -> None:
        self.actions = actions
        self.version = version
        self.error = error
        self.t_resolve = time.perf_counter()
        self.event.set()


class RequestScheduler:
    """Deadline/size-admission micro-batcher feeding one engine.

    ``weights`` is anything with ``pull() -> (version, params)``, in practice
    :class:`~sheeprl_tpu_torch.serve.weights.WeightStore`. For a session
    engine each admitted session request resolves to its slab row, and on a
    new weight version the engine checks once whether the live sessions'
    state still fits. ``seed`` keys a stateless engine's sample-mode draws.
    """

    def __init__(
        self,
        engine: Any,
        weights: Any,
        max_wait_s: float = 0.005,
        max_batch: Optional[int] = None,
        queue_bound: int = 256,
        stats: Optional[ServeStats] = None,
        seed: int = 0,
    ) -> None:
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        self.engine = engine
        self.weights = weights
        self.sessions = getattr(engine, "cache", None)  # None: a stateless engine
        self.max_wait_s = float(max_wait_s)
        self.max_batch = int(max_batch) if max_batch else (max(engine.buckets) if engine.buckets else 128)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        self.queue_bound = int(queue_bound)
        self.stats = stats or ServeStats()
        self._last_version: Optional[int] = None
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=self.queue_bound)
        self.stats._depth_fn = self._q.qsize
        self.stats._sessions_fn = self.sessions.snapshot if self.sessions is not None else None
        self._seed = int(seed)
        self._batch_idx = 0
        self._holdover: Optional[_Request] = None
        self._inflight: Optional[List[_Request]] = None  # collected, not yet resolved
        self._requeue: List[_Request] = []  # recovered from a dead worker generation
        self._stop = threading.Event()
        self._closed = threading.Event()
        self._worker: Optional[threading.Thread] = threading.Thread(target=self._run, name="serve-scheduler",
                                                                     daemon=True)
        self._handle = None  # the supervisor's WorkerHandle when supervised
        self._started = False
        #: a serve.flywheel.TrajectoryLog when the flywheel is on
        self.flywheel: Any = None

    # -- lifecycle ----------------------------------------------------------- #

    def start(self, supervisor: Any = None) -> "RequestScheduler":
        """Start the admission worker; with ``supervisor`` it runs
        supervised, a crash restarting it with its admitted batch recovered.
        There is no heartbeat lease: a dispatch's time is the engine's."""
        if not self._started:
            self._started = True
            if supervisor is None:
                self._worker.start()
            else:
                self._worker = None
                self._handle = supervisor.spawn("serve-scheduler", self._run,
                                                on_restart=lambda ctx: self.recover_inflight(), lease_s=None)
        return self

    def worker_alive(self) -> bool:
        """Is the admission worker live (a supervised one in restart backoff counts)?"""
        if self._handle is not None:
            return self._handle.live()
        return self._worker is not None and self._worker.is_alive()

    def recover_inflight(self) -> int:
        """Re-queue the batch a dead worker generation had admitted but not
        resolved, to be served first, in admission order; returns how many
        requests it held. Call only between generations (the supervisor's
        restart hook)."""
        recovered, self._inflight = self._inflight, None
        if recovered:
            self._requeue = list(recovered) + self._requeue
        return len(recovered or ())

    def stop(self) -> None:
        """Stop the worker after it has served every request already
        admitted (a graceful drain); new submits raise
        :class:`ServeClosedError`."""
        self._closed.set()
        self._stop.set()
        if self._handle is not None:
            self._handle.retire()  # no respawn racing this stop
        worker = self._handle.thread if self._handle is not None else self._worker
        if self._started and worker is not None:
            worker.join(timeout=30.0)
            if worker.is_alive():
                return  # still mid-dispatch: its own shutdown loop drains
        # a submit that passed the closed check just before stop() may have
        # enqueued after the worker's last drain sweep, and a supervised
        # worker that crashed while stopping left its batch behind
        leftovers = list(self._inflight or ())
        self._inflight = None
        leftovers += self._take_pending()
        if leftovers:
            self._settle(leftovers)

    # -- client side --------------------------------------------------------- #

    def submit(
        self,
        obs: Dict[str, np.ndarray],
        timeout: Optional[float] = None,
        session_id: Optional[str] = None,
        reset: bool = False,
        reward: Any = None,
        done: Any = None,
        stream: Optional[str] = None,
    ) -> _Request:
        """Enqueue a prepared batch; returns the request future. Blocks while
        the queue is at its bound; ``timeout`` seconds later it gives up with
        :class:`ServeOverloadedError`. ``session_id`` names the caller's
        session (one row); ``reset`` restarts its state before stepping; no
        ``session_id`` serves a one-shot step from a fresh state. ``reward``
        and ``done`` are the flywheel's feedback on the previous action of
        ``stream`` (default: the session); they never change the answer."""
        if self._closed.is_set():
            raise ServeClosedError("scheduler is stopped")
        if session_id is not None and self.sessions is None:
            raise ValueError("session_id on a stateless server (this policy carries no per-user state)")
        n = self.engine.policy.validate_batch(obs)
        if session_id is not None and n != 1:
            raise ValueError(f"a session request is one state row, got n={n}")
        req = _Request(obs, n, session_id=session_id, reset=reset, reward=reward, done=done,
                       stream=stream if stream is not None else session_id)
        try:
            if timeout is None:
                while not self._closed.is_set():
                    try:
                        self._q.put(req, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    raise ServeClosedError("scheduler stopped while waiting for queue space")
            elif timeout <= 0:
                self._q.put_nowait(req)
            else:
                self._q.put(req, timeout=timeout)
        except queue.Full:
            self.stats.add("rejected", 1)
            raise ServeOverloadedError(f"request queue held {self.queue_bound} pending requests for {timeout}s") from None
        self.stats.add("requests", 1)
        self.stats.observe_depth(self._q.qsize())
        return req

    def result(self, req: _Request, timeout: Optional[float] = None) -> Tuple[np.ndarray, int]:
        """Block until ``req`` resolves; returns ``(actions, weight_version)``."""
        if not req.event.wait(timeout):
            raise ServeTimeoutError(f"request did not resolve within {timeout}s")
        if req.error is not None:
            raise req.error
        self.stats.observe_latency(req.latency_s)
        return req.actions, req.version

    # -- worker side --------------------------------------------------------- #

    def _next_request(self, timeout: float) -> Optional[_Request]:
        if self._requeue:  # recovered from a dead generation first: admission order survives
            return self._requeue.pop(0)
        if self._holdover is not None:
            req, self._holdover = self._holdover, None
            return req
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _collect(self) -> List[_Request]:
        """One admission round (see the module docstring)."""
        first = self._next_request(timeout=0.05)
        if first is None:
            return []
        batch = [first]
        rows = first.n
        seen = {first.session_id} if first.session_id is not None else set()
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            nxt = self._next_request(timeout=remaining)
            if nxt is None:
                break
            if rows + nxt.n > self.max_batch or (nxt.session_id is not None and nxt.session_id in seen):
                self._holdover = nxt  # the head of the next batch
                break
            batch.append(nxt)
            rows += nxt.n
            if nxt.session_id is not None:
                seen.add(nxt.session_id)
        return batch

    def _serve_batch(self, batch: List[_Request]) -> None:
        rows = sum(r.n for r in batch)
        obs = (
            batch[0].obs
            if len(batch) == 1
            else {k: np.concatenate([r.obs[k] for r in batch], axis=0) for k in batch[0].obs}
        )
        version, params = self.weights.pull()  # one snapshot for every row of the batch
        try:
            if self.sessions is None:
                key = None
                if not self.engine.greedy:
                    key = (self._seed, self._batch_idx)
                    self._batch_idx += 1
                actions = self.engine.infer(params, obs, key=key)
            else:
                if version != self._last_version:
                    # once per new version: compatible weights keep the
                    # sessions, incompatible ones version-and-reinit the cache
                    self.engine.check_swap(params)
                    self._last_version = version
                session_ids: List[Optional[str]] = []
                resets: List[bool] = []
                for r in batch:
                    if r.session_id is None:
                        session_ids.extend([None] * r.n)
                        resets.extend([False] * r.n)
                    else:
                        session_ids.append(r.session_id)
                        resets.append(r.reset)
                actions = self.engine.step_sessions(params, obs, session_ids, resets)
        except Exception as e:  # resolve the callers with the error, keep serving
            for r in batch:
                r.resolve(None, version, error=e)
            return
        self.stats.observe_version(version)
        self.stats.add("batches", 1)
        self.stats.add("rows_served", rows)
        start = 0
        log = self.flywheel
        for r in batch:
            rows = actions[start : start + r.n]
            r.resolve(rows, version)
            start += r.n
            if log is not None:  # after the resolve, and never raising
                log.observe(r.obs, r.n, rows, r.reward, r.done, r.stream)

    def _settle(self, pending: List[_Request]) -> None:
        """Shutdown: serve ``pending`` in order, in batches of at most
        ``max_batch`` rows and one request per session."""
        batch: List[_Request] = []
        rows = 0
        seen: set = set()
        for r in pending:
            if batch and (rows + r.n > self.max_batch or (r.session_id is not None and r.session_id in seen)):
                self._serve_batch(batch)
                batch, rows, seen = [], 0, set()
            batch.append(r)
            rows += r.n
            if r.session_id is not None:
                seen.add(r.session_id)
        if batch:
            self._serve_batch(batch)

    def _take_pending(self) -> List[_Request]:
        pending: List[_Request] = list(self._requeue)
        self._requeue = []
        if self._holdover is not None:
            pending.append(self._holdover)
            self._holdover = None
        while True:
            try:
                pending.append(self._q.get_nowait())
            except queue.Empty:
                return pending

    def _run(self, ctx: Any = None) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while not self._stop.is_set():
            if self.sessions is not None:
                self.sessions.maybe_sweep()  # TTL sweep rides the admission loop
            batch = self._collect()
            if batch:
                # what makes a worker's death lossless: recover_inflight hands
                # this batch to the next generation if this one dies here
                self._inflight = batch
                fault_point("serve.scheduler.batch")
                self._serve_batch(batch)
                self._inflight = None
        while True:  # shutdown: settle everything already admitted
            pending = self._take_pending()
            if not pending:
                break
            self._settle(pending)
        if ctx is not None:
            ctx.retire()  # an owner-driven stop: expected, not a crash to restart
