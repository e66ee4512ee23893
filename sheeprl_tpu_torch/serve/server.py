"""Server assembly: in-process client, JSON-lines socket front end and the
``serve`` entry body (counterpart of ``sheeprl_tpu/serve/server.py``).

Wire protocol (one JSON object per line, both directions)::

    -> {"obs": {"state": [[...], [...]]}, "n": 2}  # stateless: n raw rows
    <- {"actions": [[...], [...]], "version": 3}
    -> {"obs": {"rgb": [[[...]]]}, "session_id": "user-42"}  # stateful
    -> {"obs": {...}, "session_id": "user-42", "reset": true}  # new episode
    <- {"error": "..."}                       # per-request failure
    -> {"health": true}
    <- {"status": "ok", "ready": true, ...}   # liveness/readiness probe
    -> {"obs": {...}, "reward": 0.7, "done": false}  # flywheel feedback

``obs`` leaves are raw env observations (the server applies the policy's own
``prepare``), ``n`` (default 1) of them batched along the first axis. A
stateless policy (:class:`~sheeprl_tpu_torch.serve.policy.ServePolicy`, PPO
and SAC) answers each row on its own. A stateful one
(:class:`~sheeprl_tpu_torch.serve.policy.StatefulServePolicy`, DreamerV3)
binds a request with ``session_id`` to a server-side state row; without it,
``n`` one-shot rows are stepped from a fresh state. ``serve_policy`` stops on
SIGTERM/SIGINT with a graceful drain: it stops accepting, serves every
admitted request, then returns.

With ``serve.flywheel.enabled`` (the serve→train loop,
:mod:`~sheeprl_tpu_torch.serve.flywheel`) a request's optional ``reward`` and
``done`` grade the PREVIOUS action served on its stream (the session, else
the connection, else the in-process client); the server logs the completed
transitions into the spool directory, and ``serve_policy`` supervises the
learner process that trains on them. An algorithm with no registered
learner-ingest, or no spool directory, raises
:class:`~sheeprl_tpu_torch.serve.flywheel.FlywheelConfigError` before a
socket binds. Omitting the fields serves as before.

With ``serve.watch`` a :class:`~sheeprl_tpu_torch.serve.weights.CheckpointWatcher`
watches the served checkpoint's directory and publishes each newer complete
save into the weight store (hot swap: versions only go up, no request is
dropped or torn). The scheduler worker and the watcher run under one
:class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor` with a monitor
thread, which restarts a crashed worker; the health probe reports the
engine, scheduler, watcher and store, and turns ``degraded`` when the
weights are older than ``serve.max_staleness_s``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.fault.supervisor import Supervisor
from sheeprl_tpu_torch.ops.kernels import LAUNCHES
from sheeprl_tpu_torch.serve.engine import BucketEngine, NaiveEngine, default_buckets
from sheeprl_tpu_torch.serve.policy import ServePolicy, StatefulServePolicy
from sheeprl_tpu_torch.serve.scheduler import RequestScheduler, ServeStats
from sheeprl_tpu_torch.serve.sessions import SessionEngine, default_session_buckets
from sheeprl_tpu_torch.serve.weights import CheckpointWatcher, WeightStore

__all__ = ["PolicyClient", "PolicyServer", "install_drain_handlers", "request_over_socket", "serve_policy"]


class PolicyClient:
    """In-process client: raw env observations in, env-format actions out.
    Concurrent callers are micro-batched into shared dispatches.
    ``timeout_s`` bounds the waits a call leaves unset (None: no bound); its
    expiry raises :class:`~sheeprl_tpu_torch.serve.scheduler.ServeTimeoutError`.
    ``stream`` is the flywheel's pairing identity of a caller without a
    session (default: this client)."""

    def __init__(self, policy: "ServePolicy | StatefulServePolicy", scheduler: RequestScheduler,
                 timeout_s: Optional[float] = None, stream: Optional[str] = None) -> None:
        self.policy = policy
        self.scheduler = scheduler
        self.timeout_s = timeout_s
        self.stream = stream if stream is not None else f"client-{id(self):x}"

    def act(
        self,
        obs: Dict[str, np.ndarray],
        n: int = 1,
        timeout: Optional[float] = None,
        submit_timeout: Optional[float] = None,
        session_id: Optional[str] = None,
        reset: bool = False,
        reward: Any = None,
        done: Any = None,
        stream: Optional[str] = None,
    ) -> Tuple[np.ndarray, int]:
        """Actions ``(n, action_dim)`` and the weight version that produced
        them. ``timeout`` bounds the wait for the result, ``submit_timeout``
        the wait for queue space (both default to the client's
        ``timeout_s``). ``reward``/``done`` (a scalar or ``n`` values) are
        feedback on the previous action served to ``stream`` (default: the
        session, else this client); they never change the answer."""
        timeout = self.timeout_s if timeout is None else timeout
        submit_timeout = self.timeout_s if submit_timeout is None else submit_timeout
        prepared = self.policy.prepare(obs, n)
        if stream is None:
            stream = session_id if session_id is not None else self.stream
        req = self.scheduler.submit(prepared, timeout=submit_timeout, session_id=session_id, reset=reset,
                                    reward=reward, done=done, stream=stream)
        return self.scheduler.result(req, timeout=timeout)


class _JsonLineHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one connection, many newline-framed requests
        server: "_TcpFrontEnd" = self.server  # type: ignore[assignment]
        conn_stream = f"conn-{self.client_address[0]}:{self.client_address[1]}"  # feedback pairs per connection
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                if msg.get("health"):
                    resp = server.health_fn()
                else:
                    obs = {k: np.asarray(v) for k, v in msg["obs"].items()}
                    session_id = msg.get("session_id")
                    actions, version = server.client.act(
                        obs,
                        n=int(msg.get("n", 1)),
                        timeout=server.request_timeout_s,
                        submit_timeout=server.request_timeout_s,
                        session_id=None if session_id is None else str(session_id),
                        reset=bool(msg.get("reset", False)),
                        reward=msg.get("reward"),
                        done=msg.get("done"),
                        stream=conn_stream if session_id is None else str(session_id),
                    )
                    resp = {"actions": np.asarray(actions).tolist(), "version": int(version)}
            except Exception as e:  # per request: report it, keep the connection
                resp = {"error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):  # the client went away
                return


class _TcpFrontEnd(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, client: PolicyClient, request_timeout_s: float, health_fn: Callable[[], Dict[str, Any]]):
        super().__init__(addr, _JsonLineHandler)
        self.client = client
        self.request_timeout_s = request_timeout_s
        self.health_fn = health_fn


class PolicyServer:
    """One policy, fully assembled: its engine, the scheduler, the versioned
    weight store and, with ``serve.port`` set, the socket front end.
    ``serve_cfg`` mirrors the ``serve`` block of
    :data:`sheeprl_tpu_torch.config.SERVE_DEFAULTS`. The engine follows the
    policy's type: a :class:`StatefulServePolicy` gets the
    :class:`SessionEngine`; a :class:`ServePolicy` gets the
    :class:`BucketEngine` (``serve.engine=aot``) or the per-request
    :class:`NaiveEngine` (``naive``). ``watch_dir`` (a run's
    ``checkpoint/`` directory) starts a checkpoint watcher over it. With
    ``serve.flywheel.enabled`` the scheduler logs into a
    :class:`~sheeprl_tpu_torch.serve.flywheel.TrajectoryLog`
    (``self.flywheel``); ``learner_probe``, when an owner sets it, fills the
    health probe's ``flywheel.learner`` block."""

    def __init__(self, policy: "ServePolicy | StatefulServePolicy", serve_cfg: Optional[Dict[str, Any]] = None,
                 watch_dir: "str | os.PathLike | None" = None) -> None:
        cfg = dict(serve_cfg or {})
        self.policy = policy
        self.stats = ServeStats()
        mode = str(cfg.get("mode", "greedy"))
        if mode not in ("greedy", "sample"):
            raise ValueError(f"serve.mode must be greedy|sample, got {mode!r}")
        engine = str(cfg.get("engine") or "aot")
        if engine not in ("aot", "naive"):
            raise ValueError(f"serve.engine must be aot|naive, got {engine!r}")
        self.stateful = isinstance(policy, StatefulServePolicy)
        if self.stateful:
            if engine != "aot":
                raise ValueError(
                    "stateful policies serve through the session engine; for a per-session baseline use "
                    "serve.session.buckets=[1] with serve.max_batch=1"
                )
            scfg = dict(cfg.get("session") or {})
            self.engine: Any = SessionEngine(
                policy,
                buckets=scfg.get("buckets") or default_session_buckets(),
                mode=mode,
                max_sessions=int(scfg.get("max_sessions", 1024)),
                ttl_s=float(scfg.get("ttl_s", 300.0)),
                sweep_every_s=float(scfg.get("sweep_every_s", 1.0)),
            )
        elif engine == "aot":
            self.engine = BucketEngine(policy, buckets=cfg.get("buckets") or default_buckets(), mode=mode)
        else:
            self.engine = NaiveEngine(policy, mode=mode)
        self.weights = WeightStore(policy.params, policy.params_from_state, stats=self.stats)
        self.scheduler = RequestScheduler(
            self.engine,
            self.weights,
            max_wait_s=float(cfg.get("max_wait_ms", 5.0)) / 1e3,
            max_batch=cfg.get("max_batch"),
            queue_bound=int(cfg.get("queue_bound", 256)),
            stats=self.stats,
            seed=int(cfg.get("seed") or 0),
        )
        self.client = PolicyClient(policy, self.scheduler, timeout_s=cfg.get("client_timeout_s"))
        self._request_timeout_s = float(cfg.get("request_timeout_s", 30.0) or 30.0)
        # the staleness alarm: weights older than this turn the probe to
        # degraded, and Serve/weights_stale counts the ok -> stale turns
        max_stale = cfg.get("max_staleness_s")
        self._max_staleness_s = float(max_stale) if max_stale else None
        self._was_stale = False
        self._watch_publish_current = bool(cfg.get("watch_publish_current", False))
        self.supervisor = Supervisor.from_config(dict(cfg.get("supervisor") or {}), name="serve", max_restarts=3,
                                                 backoff=0.25)
        self.watcher: Optional[CheckpointWatcher] = None
        if watch_dir is not None:
            self.watcher = CheckpointWatcher(
                watch_dir, self.weights, poll_s=float(cfg.get("watch_poll_s", 2.0)), stats=self.stats,
                quarantine_after=int(cfg.get("watcher_quarantine_after", 3)),
            )
        self._tcp: Optional[_TcpFrontEnd] = None
        self._tcp_thread: Optional[threading.Thread] = None
        self._host = str(cfg.get("host", "127.0.0.1"))
        self._port = cfg.get("port", None)
        self._draining = False
        self.flywheel = None
        self.learner_probe: Optional[Callable[[], Dict[str, Any]]] = None
        fly = dict(cfg.get("flywheel") or {})
        if fly.get("enabled"):  # a misconfiguration fails here, before a socket binds
            self.flywheel = _trajectory_log(policy, fly)
            self.scheduler.flywheel = self.flywheel
            self.stats._flywheel_fn = self.flywheel.snapshot

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """Bound (host, port) of the socket front end, if one is up."""
        return self._tcp.server_address[:2] if self._tcp is not None else None

    def start(self, with_socket: Optional[bool] = None) -> "PolicyServer":
        self.scheduler.start(supervisor=self.supervisor)
        if self.watcher is not None:
            self.watcher.start(publish_current=self._watch_publish_current, supervisor=self.supervisor)
        self.supervisor.start_monitor(poll_s=0.5)
        if (self._port is not None) if with_socket is None else with_socket:
            self._tcp = _TcpFrontEnd(
                (self._host, int(self._port or 0)), self.client, self._request_timeout_s, self.health
            )
            self._tcp_thread = threading.Thread(target=self._tcp.serve_forever, name="serve-tcp", daemon=True)
            self._tcp_thread.start()
        return self

    def health(self) -> Dict[str, Any]:
        """Liveness and readiness (served over the socket as ``{"health":
        true}``): the engine, the scheduler, the watcher and the store (version,
        the step it was published from, age, the staleness alarm), the
        supervisor's workers, session counters and drain state."""
        alive = self.scheduler.worker_alive()
        watcher_alive = self.watcher.alive() if self.watcher is not None else None
        fatal = self.supervisor.fatal
        staleness = self.weights.staleness_s
        stale = self._max_staleness_s is not None and staleness > self._max_staleness_s
        if stale and not self._was_stale:
            self.stats.add("weights_stale", 1)
        self._was_stale = stale
        healthy = alive and watcher_alive in (None, True) and fatal is None and not stale
        status = "draining" if self._draining else ("ok" if healthy else "degraded")
        workers = self.supervisor.snapshot()
        out = {
            "status": status,
            "ready": bool(alive and not self._draining),
            "engine": {
                "kind": type(self.engine).__name__,
                "device": str(self.engine.device),
                "buckets": [int(b) for b in self.engine.buckets],
                **self.engine.stats(),
                "launches": dict(LAUNCHES),  # this process's kernel launches
            },
            "scheduler": {
                "alive": bool(alive),
                "queue_depth": int(self.scheduler._q.qsize()),
                "restarts": int(workers.get("serve-scheduler", {}).get("restarts", 0)),
            },
            "weights": {
                "version": int(self.weights.version),
                "step": int(self.watcher.last_step) if self.watcher is not None else int(self.weights.version),
                "staleness_s": round(staleness, 3),
                "stale": bool(stale),
            },
            "supervisor": {"fatal": str(fatal) if fatal is not None else None, "workers": workers},
        }
        if self.watcher is not None:
            out["watcher"] = {
                "alive": bool(watcher_alive),
                "errors": int(self.stats.watcher_errors),
                "published": int(self.watcher.published),
                "quarantined": [str(p) for p in sorted(self.watcher.quarantined)],
                "restarts": int(workers.get("serve-ckpt-watcher", {}).get("restarts", 0)),
            }
        if self.flywheel is not None:
            fl = self.flywheel.snapshot()
            out["flywheel"] = {k: int(fl[k]) for k in ("rows_logged", "rows_shed", "feedback_missing",
                                                      "feedback_orphans", "transport_depth", "rows_spooled",
                                                      "spool_bytes", "errors")}
            out["flywheel"]["replica"] = str(self.flywheel.replica)
            if self.learner_probe is not None:
                out["flywheel"]["learner"] = self.learner_probe()
        if self.stateful:
            s = self.engine.cache.snapshot()
            out["sessions"] = {
                "live": int(s["live"]),
                "peak": int(s["peak"]),
                "max_sessions": int(s["max_sessions"]),
                "opened": int(s["opened"]),
                "evictions": int(s["evicted_lru"] + s["evicted_ttl"]),
                "ttl_evictions": int(s["evicted_ttl"]),
                "resets": int(s["resets"]),
                "client_resets": int(s["client_resets"]),
                "state_bytes": int(s["state_bytes"]),
                "ttl_s": float(s["ttl_s"]),
            }
        return out

    def stop(self) -> None:
        """Graceful drain: stop accepting (socket down, submits closed),
        serve every admitted request, then stop the worker."""
        self._draining = True
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        # no restarts from here: a crash racing the shutdown falls to the
        # scheduler's own settling of what it had admitted
        self.supervisor.request_stop()
        self.supervisor.stop_monitor()
        if self.watcher is not None:
            self.watcher.stop()
        self.scheduler.stop()
        if self.flywheel is not None:  # after the drain: the settled requests' rows spool too
            self.flywheel.close()

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _trajectory_log(policy: Any, fly: Dict[str, Any]) -> Any:
    """The server's :class:`~sheeprl_tpu_torch.serve.flywheel.TrajectoryLog`
    from a ``serve.flywheel`` mapping; raises
    :class:`~sheeprl_tpu_torch.serve.flywheel.FlywheelConfigError` for an
    algorithm without a learner-ingest, or without a spool directory."""
    from sheeprl_tpu_torch.serve.flywheel import FlywheelConfigError, TrajectoryLog
    from sheeprl_tpu_torch.utils.registry import registered_flywheel_ingest_names, resolve_flywheel_ingest

    if resolve_flywheel_ingest(str(policy.name)) is None:
        raise FlywheelConfigError(
            f"serve.flywheel is enabled but the algorithm named '{policy.name}' has no registered learner-ingest "
            f"builder. Algorithms with flywheel support: {', '.join(registered_flywheel_ingest_names())}."
        )
    if not fly.get("dir"):
        raise FlywheelConfigError(
            "serve.flywheel.enabled=True needs serve.flywheel.dir (the shared spool directory the learner tails); "
            "`serve --flywheel` derives it from the checkpoint dir automatically"
        )
    return TrajectoryLog(
        fly["dir"],
        policy.obs_spec,
        int(policy.action_dim),
        replica=str(fly.get("replica") or f"replica-{os.getpid()}"),
        block_rows=int(fly.get("block_rows", 256) or 256),
        queue_blocks=int(fly.get("queue_blocks", 8) or 8),
        flush_s=float(fly.get("flush_s", 0.25) or 0.25),
        max_streams=int(fly.get("max_streams", 4096) or 4096),
    )


def request_over_socket(addr: Tuple[str, int], payload: Dict[str, Any], timeout: float = 30.0) -> Dict[str, Any]:
    """One JSON-lines round trip on a fresh connection (tests and examples;
    real clients keep one connection open for many requests)."""
    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def install_drain_handlers(event: threading.Event) -> Callable[[], None]:
    """Make SIGTERM/SIGINT set ``event`` (a graceful drain); returns a
    callable that restores the old handlers. A no-op off the main thread,
    where Python delivers no signals."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def _handler(signum, frame) -> None:
        event.set()
        try:  # os.write: print() can raise a reentrant-call error in a handler
            os.write(1, f"serve: received {signal.Signals(signum).name}, draining\n".encode())
        except OSError:
            pass

    previous = {s: signal.signal(s, _handler) for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore() -> None:
        for s, h in previous.items():
            signal.signal(s, h)

    return _restore


def serve_policy(cfg: Any, state: Optional[Dict[str, Any]], builder: Callable, device: torch.device) -> None:
    """The ``serve`` entry body: build the policy from the checkpoint state on
    ``device`` and serve it until ``serve.max_requests`` requests have been
    answered (None: until SIGTERM/SIGINT). Prints a ``Serve/*`` snapshot
    every ``serve.log_every_s`` seconds and once at the end. With the
    flywheel on, the spool directory defaults to ``flywheel/`` beside the
    checkpoint, and unless ``serve.flywheel.learner`` is false this process
    supervises the learner (:class:`~sheeprl_tpu_torch.serve.flywheel.LearnerSupervisor`),
    ticked from the serve loop: a wedged or dead learner never stops serving."""
    policy = builder(cfg, state, device)
    serve_cfg = dict(cfg.get("serve", {}))
    watch_dir = os.path.dirname(os.path.abspath(str(cfg.checkpoint_path))) if serve_cfg.get("watch") else None
    fly_cfg = dict(serve_cfg.get("flywheel") or {})
    if fly_cfg.get("enabled"):
        if not fly_cfg.get("dir"):  # the defaults carry dir: None
            fly_cfg["dir"] = os.path.join(os.path.dirname(os.path.abspath(str(cfg.checkpoint_path))), "flywheel")
        if not fly_cfg.get("replica"):
            fly_cfg["replica"] = f"replica-{os.getpid()}"
        serve_cfg["flywheel"] = fly_cfg
    server = PolicyServer(policy, serve_cfg, watch_dir=watch_dir)
    learner_sup = None
    if fly_cfg.get("enabled") and fly_cfg.get("learner", True):
        from sheeprl_tpu_torch.serve.flywheel import LearnerSupervisor

        learner_sup = LearnerSupervisor(cfg, fly_cfg["dir"])
        server.learner_probe = learner_sup.probe
    max_requests = serve_cfg.get("max_requests")
    log_every_s = float(serve_cfg.get("log_every_s", 10.0) or 10.0)
    drain = threading.Event()
    restore_handlers = install_drain_handlers(drain)
    server.start()
    try:
        addr = server.address
        if addr is not None:
            print(f"serving {cfg.algo.name} on {addr[0]}:{addr[1]} (device={device}, buckets={list(server.engine.buckets)})"
                  + (f", watching {watch_dir}" if watch_dir else ""), flush=True)
        last_log = time.perf_counter()
        while not drain.is_set():
            drain.wait(0.2)
            if learner_sup is not None:
                learner_sup.tick()
            if time.perf_counter() - last_log >= log_every_s:
                print(json.dumps({**server.stats.snapshot(), **server.engine.stats()}), flush=True)
                last_log = time.perf_counter()
            if max_requests is not None and server.stats.requests >= int(max_requests):
                break
    finally:
        server.stop()
        if learner_sup is not None:
            learner_sup.stop()
        restore_handlers()
        print(json.dumps({**server.stats.snapshot(), **server.engine.stats()}), flush=True)
        if drain.is_set():
            print("serve: drained cleanly", flush=True)
