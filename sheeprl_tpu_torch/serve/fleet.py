"""Replicated serving behind a health-routed front end (counterpart of
``sheeprl_tpu/serve/fleet.py``).

One :class:`~sheeprl_tpu_torch.serve.server.PolicyServer` is one process; a
fleet is N replica processes, where a process dying, a slow replica and a
kill in the middle of a weight swap are routine. :class:`FleetRouter` is the
front end over them. It speaks the single server's newline-delimited JSON
protocol, so a client cannot tell one replica from thirty:

- **least-loaded routing among READY replicas**: readiness comes from each
  replica's ``{"health": true}`` probe, polled by the router's health loop;
  load is the router's own count of requests in flight to each replica, ties
  broken on the probe's queue depth, then in rotation;
- **session-sticky routing with counted re-homing**: a stateful session's
  state row lives on its HOME replica, so every request of a ``session_id``
  goes there; when the home dies the session moves to a survivor, and the
  move is counted (``sessions_rehomed``) and visible to the client: the first
  request after it is forwarded with ``reset`` and its answer carries
  ``"rehomed": true``, so the stream restarts visibly from its initial state,
  never silently from a wrong one;
- **a bounded retry on failover**: a connection failure to a replica (it
  died mid-request) sends the request to a survivor, at most
  ``retry_budget`` times;
- **fleet-wide shedding**: with no READY replica below ``max_inflight`` the
  router answers with the tier's ``ServeOverloadedError`` instead of queueing
  without bound; a replica's own overload answer is retried once elsewhere;
- **rolling swaps with a non-decreasing version**: every replica watches the
  same checkpoint directory, so a new save rolls across the fleet as each
  watcher polls. Replica versions restart on a respawn, so the router keys
  on the published checkpoint's STEP (the probe's ``weights.step``): each
  connection keeps a floor, routing prefers replicas at or above it, and
  every answer carries ``fleet_version``, which never decreases for a
  client unless no replica at the floor is left (counted in
  ``version_fallbacks`` and shown, never hidden);
- **supervised replicas**: with a
  :class:`~sheeprl_tpu_torch.fault.procsup.ProcessSupervisor` the health loop
  feeds each probe success in as a beat and drives ``check()``: a SIGKILLed
  replica is detected (rc -9, apart from a hang), its sessions are re-homed
  at once, and the respawned process adopts the newest complete save
  (``serve.watch_publish_current``). ``kill-replica``/``hang-replica``
  (:func:`~sheeprl_tpu_torch.fault.inject.set_replica_chaos`) arm at the
  loop's ``serve.fleet.tick`` point;
- **the drain**: ``stop()`` closes admission, settles the requests in
  flight, SIGTERMs each replica (each drains and exits 0).

Every replica is its own CUDA process on the one card (``serve_fleet``); a
replica that finds no card exits non-zero like any failed start, and the
supervisor counts it. The knobs are ``serve.fleet.*``
(:data:`~sheeprl_tpu_torch.config.SERVE_DEFAULTS`).
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.inject import fault_point
from sheeprl_tpu_torch.fault.procsup import ProcessSupervisor
from sheeprl_tpu_torch.fault.supervisor import SupervisionError

__all__ = ["FleetReplicaError", "ReplicaEndpoint", "FleetRouter", "free_port", "replica_command", "serve_fleet"]


class FleetReplicaError(RuntimeError):
    """A connection failure talking to one replica (dial, read, timeout, or
    a torn answer). The failover path catches it; a client sees it only when
    the retry budget is spent."""

    def __init__(self, replica: str, detail: str, timed_out: bool = False) -> None:
        self.replica = replica
        self.timed_out = timed_out
        super().__init__(f"replica '{replica}': {detail}")


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port that binds now, picked below the kernel's ephemeral range.
    A replica binds its port seconds after the pick (imports, the card's
    context, the checkpoint), and a respawn binds it again; a port of the
    ephemeral range may meanwhile become the local end of any outgoing
    connection (a client's, a probe's) and refuse the bind."""
    low = _ephemeral_low()
    rng = random.Random()
    for _ in range(64):
        port = rng.randrange(max(1024, low - 16384), low)
        with socket.socket() as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
            return port
    with socket.socket() as s:  # the range below is crowded: let the OS pick
        s.bind((host, 0))
        return s.getsockname()[1]


class ReplicaEndpoint:
    """One replica seen from the router: pooled JSON-lines connections with
    connect and read timeouts, and the view the router keeps of it. A replica
    that accepts a connection and never answers (a wedged dispatch, SIGSTOP)
    fails the call with a typed :class:`FleetReplicaError` within
    ``request_timeout_s``."""

    def __init__(self, name: str, host: str, port: int, connect_timeout_s: float = 2.0,
                 request_timeout_s: float = 30.0) -> None:
        self.name = name
        self.host = host
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self._pool: List[socket.socket] = []
        self._pool_lock = threading.Lock()
        # the router's view, written by its health loop and failover path
        self.ready = False
        self.status = "unknown"
        self.version = -1
        self.step = -1  # the published checkpoint's step: comparable across replicas
        self.queue_depth = 0
        self.health: Dict[str, Any] = {}
        self.consecutive_failures = 0
        self.inflight = 0  # requests the router has in flight here
        self.probe_inflight = False  # one probe at a time

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def _checkout(self) -> Tuple[socket.socket, bool]:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return socket.create_connection(self.address, timeout=self.connect_timeout_s), False

    def _checkin(self, sock: socket.socket) -> None:
        with self._pool_lock:
            self._pool.append(sock)

    def close(self) -> None:
        """Drop every pooled connection (a respawned replica's old ones are
        dead; the next request dials afresh)."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass

    @staticmethod
    def _round_trip(sock: socket.socket, line: bytes, timeout_s: float) -> Dict[str, Any]:
        sock.settimeout(timeout_s)
        sock.sendall(line)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionResetError("replica closed the connection mid-response")
            buf += chunk
        return json.loads(buf.decode())

    def _attempt(self, sock: socket.socket, line: bytes, timeout_s: float) -> Dict[str, Any]:
        """One round trip; on any failure the socket is closed and a
        :class:`FleetReplicaError` raised (``timed_out`` for a read timeout:
        the wedged-replica signal)."""
        try:
            return self._round_trip(sock, line, timeout_s)
        except socket.timeout as e:
            sock.close()
            raise FleetReplicaError(self.name, f"no response within {timeout_s}s", timed_out=True) from e
        except (OSError, ValueError) as e:
            sock.close()
            raise FleetReplicaError(self.name, f"{type(e).__name__}: {e}") from e

    def request(self, payload: Dict[str, Any], timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """One JSON-lines round trip. A failure other than a timeout on a
        pooled socket retries once on a fresh dial (the pooled one may be
        stale from a respawn); a timeout never retries: the replica is
        wedged, not the socket."""
        timeout_s = self.request_timeout_s if timeout_s is None else float(timeout_s)
        line = (json.dumps(payload) + "\n").encode()
        try:
            sock, pooled = self._checkout()
        except OSError as e:  # dial refused: the replica is gone
            raise FleetReplicaError(self.name, f"{type(e).__name__}: {e}") from e
        try:
            resp = self._attempt(sock, line, timeout_s)
        except FleetReplicaError as first:
            if not pooled or first.timed_out:
                raise
            try:
                sock = socket.create_connection(self.address, timeout=self.connect_timeout_s)
            except OSError as e:
                raise FleetReplicaError(self.name, f"{type(e).__name__}: {e}") from e
            resp = self._attempt(sock, line, timeout_s)
        self._checkin(sock)
        return resp

    def probe(self, timeout_s: float) -> Dict[str, Any]:
        """One ``{"health": true}`` round trip."""
        return self.request({"health": True}, timeout_s=timeout_s)


class _ConnState:
    """Per client connection: the weight-step floor that keeps its
    ``fleet_version`` from going down."""

    __slots__ = ("floor",)

    def __init__(self) -> None:
        self.floor = -1


class _RouterHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one connection, many newline-framed requests
        server: "_RouterTcp" = self.server  # type: ignore[assignment]
        conn = _ConnState()
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                resp = server.router.health() if msg.get("health") else server.router._serve_tracked(msg, conn)
            except Exception as e:  # per request: report it, keep the connection
                resp = {"error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return


class _RouterTcp(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, router: "FleetRouter") -> None:
        super().__init__(addr, _RouterHandler)
        self.router = router


class FleetRouter:
    """The front end over N replica endpoints (see the module docstring).
    ``fleet_cfg`` is a ``serve.fleet``-shaped mapping (``health_poll_s``,
    ``health_timeout_s``, ``retry_budget``, ``max_inflight``,
    ``request_timeout_s``). With ``procsup`` the health loop drives its
    checks; with ``owns_replicas`` ``stop()`` also drains the processes."""

    def __init__(self, endpoints: List[ReplicaEndpoint], fleet_cfg: Optional[Dict[str, Any]] = None,
                 procsup: Optional[ProcessSupervisor] = None, owns_replicas: bool = False, host: str = "127.0.0.1",
                 port: Optional[int] = 0) -> None:
        if not endpoints:
            raise ValueError("a fleet needs at least one replica endpoint")
        cfg = dict(fleet_cfg or {})
        self.endpoints = list(endpoints)
        self._by_name = {ep.name: ep for ep in self.endpoints}
        if len(self._by_name) != len(self.endpoints):
            raise ValueError("replica endpoint names must be unique")
        self.procsup = procsup
        self.owns_replicas = bool(owns_replicas)
        self.health_poll_s = float(cfg.get("health_poll_s", 0.25) or 0.25)
        self.health_timeout_s = float(cfg.get("health_timeout_s", 2.0) or 2.0)
        self.retry_budget = max(0, int(cfg.get("retry_budget", 2)))
        self.max_inflight = max(1, int(cfg.get("max_inflight", 64)))
        self.request_timeout_s = float(cfg.get("request_timeout_s", 30.0) or 30.0)
        self._host = host
        self._port = port
        self._lock = threading.RLock()
        self.counters: Dict[str, int] = {
            "requests": 0,
            "routed": 0,
            "retries": 0,
            "shed": 0,
            "replica_errors": 0,
            "replica_overloads": 0,
            "sessions_rehomed": 0,
            "version_fallbacks": 0,  # served below a connection's floor, and annotated so
        }
        self._session_home: Dict[str, str] = {}
        self._pending_reset: set = set()
        self._deaths_seen: Dict[str, int] = {}
        self._rr = 0  # the rotating tie-break
        self._tick_errors = 0  # failed health ticks, counted
        self.fatal: Optional[BaseException] = None
        self._draining = False
        self._stop = threading.Event()
        self._tcp: Optional[_RouterTcp] = None
        self._tcp_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._frontend_inflight = 0

    # -- lifecycle -------------------------------------------------------------
    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """Bound (host, port) of the front end, if one is up."""
        return self._tcp.server_address[:2] if self._tcp is not None else None

    def start(self, with_socket: Optional[bool] = None) -> "FleetRouter":
        if self.procsup is not None:  # kill-replica / hang-replica act on this fleet
            inject.set_replica_chaos(kill=self._chaos_kill, hang=self._chaos_hang)
        self._health_thread = threading.Thread(target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        if (self._port is not None) if with_socket is None else with_socket:
            self._tcp = _RouterTcp((self._host, int(self._port or 0)), self)
            self._tcp_thread = threading.Thread(target=self._tcp.serve_forever, name="fleet-tcp", daemon=True)
            self._tcp_thread.start()
        return self

    def wait_ready(self, n: Optional[int] = None, timeout_s: float = 180.0) -> bool:
        """Block until ``n`` replicas (default: all) are READY; False on
        timeout."""
        want = len(self.endpoints) if n is None else int(n)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if sum(1 for ep in self.endpoints if ep.ready) >= want:
                return True
            time.sleep(0.05)
        return sum(1 for ep in self.endpoints if ep.ready) >= want

    def stop(self, drain_replicas: Optional[bool] = None) -> None:
        """The drain, outermost first: close admission (socket down), settle
        the requests in flight, then, when the router owns the processes,
        SIGTERM each replica (each drains and exits 0)."""
        with self._lock:
            self._draining = True
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        deadline = time.monotonic() + self.request_timeout_s * (1 + self.retry_budget) + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                if self._frontend_inflight == 0:
                    break
            time.sleep(0.01)
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        if self.procsup is not None:
            inject.set_replica_chaos(None, None)
            if self.owns_replicas if drain_replicas is None else bool(drain_replicas):
                self.procsup.terminate_all()
        for ep in self.endpoints:
            ep.close()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the health loop ---------------------------------------------------------
    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.health_tick()
            except Exception:  # the loop must not die; count it
                with self._lock:
                    self._tick_errors += 1
            self._stop.wait(self.health_poll_s)

    def _probe_one(self, ep: ReplicaEndpoint) -> None:
        with self._lock:
            if ep.probe_inflight:  # a wedged replica must not pile probes up
                return
            ep.probe_inflight = True
        try:
            health = ep.probe(self.health_timeout_s)
        except FleetReplicaError:
            with self._lock:
                ep.consecutive_failures += 1
                ep.ready = False
                ep.status = "unreachable"
                ep.probe_inflight = False
            ep.close()
            return
        with self._lock:
            ep.consecutive_failures = 0
            ep.probe_inflight = False
            ep.health = health
            ep.status = str(health.get("status", "unknown"))
            ep.ready = bool(health.get("ready", False))
            weights = health.get("weights") or {}
            ep.version = int(weights.get("version", -1))
            # the step only goes up: a respawning replica briefly reports -1
            ep.step = max(ep.step, int(weights.get("step", -1)))
            ep.queue_depth = int((health.get("scheduler") or {}).get("queue_depth", 0))
        if self.procsup is not None:
            self.procsup.beat(ep.name)

    def health_tick(self) -> None:
        """One poll: probe every replica at once (a wedged one's probe must
        not delay a healthy one's beat past its lease), drive the supervisor,
        re-home the sessions of any replica that died since the last tick."""
        fault_point("serve.fleet.tick")
        if len(self.endpoints) == 1:
            self._probe_one(self.endpoints[0])
        else:
            for ep in self.endpoints:  # bounded by probe_inflight and the probe timeout
                threading.Thread(target=self._probe_one, args=(ep,), daemon=True).start()
        if self.procsup is not None:
            try:
                self.procsup.check()
            except SupervisionError as e:
                self.fatal = e
            for handle in self.procsup.replicas():
                if handle.deaths > self._deaths_seen.get(handle.name, 0):
                    self._deaths_seen[handle.name] = handle.deaths
                    ep = self._by_name.get(handle.name)
                    if ep is not None:
                        with self._lock:
                            ep.ready = False
                            ep.status = "dead"
                        ep.close()
                        self._rehome_all(handle.name)

    def _chaos_kill(self) -> None:
        for handle in self.procsup.replicas() if self.procsup else ():
            if handle.is_alive():
                os.kill(handle.pid(), signal.SIGKILL)
                return

    def _chaos_hang(self) -> None:
        for handle in self.procsup.replicas() if self.procsup else ():
            if handle.is_alive():
                os.kill(handle.pid(), signal.SIGSTOP)
                return

    def _rehome_all(self, dead_name: str) -> None:
        """Un-home every session of a dead replica: each counted once and
        flagged for a visible reset on its next request (its new home is
        picked then)."""
        with self._lock:
            sids = [sid for sid, home in self._session_home.items() if home == dead_name]
            for sid in sids:
                del self._session_home[sid]
                self._pending_reset.add(sid)
                self.counters["sessions_rehomed"] += 1

    # -- routing -----------------------------------------------------------------
    def _pick(self, floor: int, exclude: set) -> Optional[ReplicaEndpoint]:
        """Least loaded among READY replicas at or above ``floor`` (else the
        READY ones at the highest step); None when none is ready or all are
        at ``max_inflight``."""
        with self._lock:
            ready = [ep for ep in self.endpoints if ep.ready and ep.name not in exclude]
            if not ready:
                return None
            eligible = [ep for ep in ready if ep.step >= floor]
            if not eligible:
                top = max(ep.step for ep in ready)
                eligible = [ep for ep in ready if ep.step == top]
            open_eps = [ep for ep in eligible if ep.inflight < self.max_inflight]
            if not open_eps:
                return None
            # rotate among equals: serial traffic (inflight 0 everywhere) still spreads
            best = min((ep.inflight, ep.queue_depth) for ep in open_eps)
            cands = [ep for ep in open_eps if (ep.inflight, ep.queue_depth) == best]
            self._rr += 1
            return cands[self._rr % len(cands)]

    def _session_pick(self, session_id: str, floor: int, exclude: set) -> Optional[ReplicaEndpoint]:
        """The session's home while it is READY (stickiness wins over load: a
        full home sheds rather than re-homes); else a survivor, the move
        counted and flagged for a reset."""
        with self._lock:
            home = self._session_home.get(session_id)
            ep = self._by_name.get(home) if home is not None else None
            if ep is not None and ep.ready and ep.name not in exclude:
                return ep if ep.inflight < self.max_inflight else None
            target = self._pick(floor, exclude)
            if target is None:
                return None
            if home is not None and target.name != home:  # a real move, not a first assignment
                self._pending_reset.add(session_id)
                self.counters["sessions_rehomed"] += 1
            self._session_home[session_id] = target.name
            return target

    def _unhome(self, session_id: Optional[str], replica: str) -> None:
        if session_id is None:
            return
        with self._lock:
            if self._session_home.get(session_id) == replica:
                del self._session_home[session_id]
                self._pending_reset.add(session_id)
                self.counters["sessions_rehomed"] += 1

    def _retry(self, budget: int) -> bool:
        if budget <= 0:
            return False
        with self._lock:
            self.counters["retries"] += 1
        return True

    def serve_request(self, msg: Dict[str, Any], conn: Optional[_ConnState] = None) -> Dict[str, Any]:
        """Route one protocol request; returns the answer (the router's own
        errors in the protocol's ``{"error": ...}`` shape)."""
        conn = conn or _ConnState()
        session_id = msg.get("session_id")
        if session_id is not None:
            session_id = str(session_id)
        with self._lock:
            self.counters["requests"] += 1
            if self._draining:
                return {"error": "ServeClosedError: fleet router is draining"}
        exclude: set = set()
        budget = self.retry_budget
        while True:
            target = (self._session_pick(session_id, conn.floor, exclude) if session_id is not None
                      else self._pick(conn.floor, exclude))
            if target is None:
                with self._lock:
                    self.counters["shed"] += 1
                return {"error": "ServeOverloadedError: no ready replica with capacity (fleet backpressure)"}
            payload = dict(msg)
            rehomed = False
            if session_id is not None:
                with self._lock:
                    rehomed = session_id in self._pending_reset
                if rehomed:
                    payload["reset"] = True
            with self._lock:
                target.inflight += 1
            try:
                resp = target.request(payload, timeout_s=self.request_timeout_s)
            except FleetReplicaError as e:
                with self._lock:
                    target.inflight -= 1
                    self.counters["replica_errors"] += 1
                    target.ready = False  # no more routing here until a probe succeeds
                    target.status = "unreachable"
                target.close()
                self._unhome(session_id, target.name)  # an undelivered reset stays pending
                exclude.add(target.name)
                budget_ok = self._retry(budget)
                budget -= 1
                if budget_ok:
                    continue
                return {"error": f"FleetReplicaError: {e}"}
            with self._lock:
                target.inflight -= 1
            if isinstance(resp, dict) and "error" in resp:
                err = str(resp["error"])
                if "ServeOverloadedError" in err:  # one sidestep, then propagate
                    with self._lock:
                        self.counters["replica_overloads"] += 1
                    exclude.add(target.name)
                    budget_ok = self._retry(budget)
                    budget -= 1
                    if budget_ok:
                        continue
                elif "ServeClosedError" in err:  # the replica is draining: as good as dead
                    with self._lock:
                        self.counters["replica_errors"] += 1
                        target.ready = False
                        target.status = "draining"
                    target.close()
                    self._unhome(session_id, target.name)
                    exclude.add(target.name)
                    budget_ok = self._retry(budget)
                    budget -= 1
                    if budget_ok:
                        continue
                return resp
            # delivered: consume the reset, annotate, raise the floor; a
            # fallback below the floor is shown as it is and counted
            with self._lock:
                self.counters["routed"] += 1
                if rehomed:
                    self._pending_reset.discard(session_id)
                fleet_version = target.step
                if fleet_version < conn.floor:
                    self.counters["version_fallbacks"] += 1
                else:
                    conn.floor = fleet_version
            out = dict(resp)
            out["replica"] = target.name
            out["fleet_version"] = int(fleet_version)
            if rehomed:
                out["rehomed"] = True
            return out

    def _serve_tracked(self, msg: Dict[str, Any], conn: _ConnState) -> Dict[str, Any]:
        """:meth:`serve_request` counted as in flight at the front end, which
        the drain waits out."""
        with self._lock:
            self._frontend_inflight += 1
        try:
            return self.serve_request(msg, conn)
        finally:
            with self._lock:
                self._frontend_inflight -= 1

    # -- aggregated health -------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """The fleet's probe answer: status, counters, and per replica its
        probe view, step and (with a supervisor) its process counters."""
        with self._lock:
            ready_n = sum(1 for ep in self.endpoints if ep.ready)
            all_ok = all(ep.ready and ep.status == "ok" for ep in self.endpoints)
            replicas: Dict[str, Any] = {
                ep.name: {
                    "ready": bool(ep.ready),
                    "status": ep.status,
                    "address": f"{ep.host}:{ep.port}",
                    "version": int(ep.version),
                    "step": int(ep.step),
                    "inflight": int(ep.inflight),
                    "queue_depth": int(ep.queue_depth),
                    "consecutive_failures": int(ep.consecutive_failures),
                }
                for ep in self.endpoints
            }
            counters = dict(self.counters)
            fleet_version = max((ep.step for ep in self.endpoints), default=-1)
        degraded_procs = False
        if self.procsup is not None:
            snap = self.procsup.snapshot()
            for name, info in snap.items():
                if name in replicas:
                    replicas[name]["proc"] = info
            degraded_procs = any(info.get("state") == "degraded" for info in snap.values())
        if self._draining:
            status = "draining"
        elif ready_n == 0:
            status = "down"
        elif all_ok and not degraded_procs and self.fatal is None:
            status = "ok"
        else:
            status = "degraded"
        return {
            "status": status,
            "ready": ready_n > 0 and not self._draining,
            "fleet": {
                "replicas": len(self.endpoints),
                "ready": ready_n,
                "fleet_version": int(fleet_version),
                "fatal": str(self.fatal) if self.fatal is not None else None,
                "tick_errors": int(self._tick_errors),
                **counters,
            },
            "replicas": replicas,
        }


# -- the fleet's entry body ------------------------------------------------------
def replica_command(cfg: Any, checkpoint_path: str, host: str, port: int, name: Optional[str] = None) -> List[str]:
    """The ``sheeprl_tpu_torch serve`` command line of ONE replica: the same
    checkpoint, its own port, watching the checkpoint's directory with
    ``watch_publish_current`` (so a respawn rejoins on the newest complete
    save), and the scalar serve knobs that survive a command line; the rest
    comes from the checkpoint's run config, as for a hand-started ``serve``.
    With the flywheel on, each replica spools into the shared directory under
    its fleet name and spawns no learner: the fleet's parent owns the one
    learner."""
    serve_cfg = dict(cfg.get("serve", {}) or {})
    cmd = [
        sys.executable,
        "-m",
        "sheeprl_tpu_torch",
        "serve",
        f"checkpoint_path={checkpoint_path}",
        f"serve.host={host}",
        f"serve.port={port}",
        "serve.fleet.replicas=0",  # a replica never starts a fleet of its own
        "serve.watch=True",
        "serve.watch_publish_current=True",
        f"fabric.accelerator={(cfg.get('fabric') or {}).get('accelerator', 'auto')}",
    ]
    if cfg.get("seed") is not None:
        cmd.append(f"seed={int(cfg['seed'])}")
    for key in ("mode", "max_wait_ms", "max_batch", "queue_bound", "watch_poll_s", "max_staleness_s", "log_every_s"):
        if serve_cfg.get(key) is not None:
            cmd.append(f"serve.{key}={serve_cfg[key]}")
    if serve_cfg.get("buckets"):
        cmd.append("serve.buckets=[" + ",".join(str(int(b)) for b in serve_cfg["buckets"]) + "]")
    fly = dict(serve_cfg.get("flywheel", {}) or {})
    if fly.get("enabled") and fly.get("dir"):
        cmd.append("serve.flywheel.enabled=True")
        cmd.append(f"serve.flywheel.dir={fly['dir']}")
        cmd.append(f"serve.flywheel.replica={name or f'replica-{port}'}")
        cmd.append("serve.flywheel.learner=False")  # one learner, the fleet parent's
        for key in ("block_rows", "queue_blocks", "flush_s", "max_streams"):
            if fly.get(key) is not None:
                cmd.append(f"serve.flywheel.{key}={fly[key]}")
    return cmd


def _spawner(cmd: List[str]) -> Callable[[], subprocess.Popen]:
    def spawn() -> subprocess.Popen:
        return subprocess.Popen(cmd)

    return spawn


def serve_fleet(cfg: Any) -> Dict[str, Any]:
    """The fleet's entry body (``serve --fleet N``, ``serve_fleet``, or
    ``serve.fleet.replicas`` >= 2): spawn N supervised replica processes on
    the checkpoint, stand the router over them, and run until SIGTERM or
    SIGINT (the drain: every replica drains and exits 0) or
    ``serve.max_requests`` routed requests; returns the router's last
    health. With ``serve.flywheel.enabled`` the parent owns the one learner
    (:class:`~sheeprl_tpu_torch.serve.flywheel.LearnerSupervisor`)."""
    from sheeprl_tpu_torch.serve.server import install_drain_handlers

    serve_cfg = dict(cfg.get("serve", {}) or {})
    fleet_cfg = dict(serve_cfg.get("fleet", {}) or {})
    n = int(fleet_cfg.get("replicas", 0) or 0)
    if n < 2:
        raise ValueError(f"serve.fleet.replicas must be >= 2 for fleet serving, got {n}")
    checkpoint_path = cfg.get("checkpoint_path")
    if not checkpoint_path:
        raise ValueError("You must specify the checkpoint path to serve")
    host = str(serve_cfg.get("host", "127.0.0.1"))
    inject.arm_from_cfg(cfg)  # the seeded chaos schedule (fault.chaos.events)
    fly_cfg = dict(serve_cfg.get("flywheel", {}) or {})
    if fly_cfg.get("enabled"):
        # one spool directory, fixed before any replica starts, for every
        # replica and the one learner
        if not fly_cfg.get("dir"):
            fly_cfg["dir"] = str(Path(os.path.abspath(str(checkpoint_path))).parent / "flywheel")
        serve_cfg["flywheel"] = fly_cfg
        cfg["serve"] = serve_cfg
    procsup = ProcessSupervisor.from_config(fleet_cfg, name="serve-fleet")
    endpoints: List[ReplicaEndpoint] = []
    for i in range(n):
        port = free_port(host)
        name = f"replica-{i}"
        cmd = replica_command(cfg, str(checkpoint_path), host, port, name=name)
        endpoints.append(ReplicaEndpoint(name, host, port,
                                         request_timeout_s=float(fleet_cfg.get("request_timeout_s", 30.0) or 30.0)))
        procsup.spawn(name, _spawner(cmd))
    router = FleetRouter(endpoints, fleet_cfg=fleet_cfg, procsup=procsup, owns_replicas=True, host=host,
                         port=serve_cfg.get("port", 0))
    learner_sup = None
    if fly_cfg.get("enabled") and fly_cfg.get("learner", True):
        from sheeprl_tpu_torch.serve.flywheel import LearnerSupervisor

        learner_sup = LearnerSupervisor(cfg, fly_cfg["dir"])
    drain = threading.Event()
    restore_handlers = install_drain_handlers(drain)
    router.start()
    addr = router.address
    if addr is not None:
        print(f"serving fleet of {n} replicas on {addr[0]}:{addr[1]} (router; replicas on "
              f"{[ep.port for ep in endpoints]})", flush=True)
    max_requests = serve_cfg.get("max_requests")
    log_every_s = float(serve_cfg.get("log_every_s", 10.0) or 10.0)
    try:
        last_log = time.perf_counter()
        while not drain.is_set():
            drain.wait(0.2)
            if learner_sup is not None:
                learner_sup.tick()
            if time.perf_counter() - last_log >= log_every_s:
                print(json.dumps(router.health()), flush=True)
                last_log = time.perf_counter()
            if max_requests is not None and router.counters["requests"] >= int(max_requests):
                break
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()  # admission closed -> each replica drained -> exit 0
        if learner_sup is not None:
            learner_sup.stop()
        restore_handlers()
        final = router.health()
        print(json.dumps(final), flush=True)
        if drain.is_set():
            print("serve: drained cleanly", flush=True)
    return final
