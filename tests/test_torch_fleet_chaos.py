"""The port's fleet under process chaos, on the CPU (JAX's
``tests/test_serve/test_fleet_chaos.py``): supervised toy replica PROCESSES
(``tests/torch_fleet_replica_main.py``: a real server around a toy policy,
no checkpoint load, no JAX) behind the router.

- The acceptance drill: 3 replicas under closed-loop load from 3 stateless
  clients and 3 sessions, one replica SIGKILLed from the seeded chaos
  schedule (``serve.fleet.tick:kill-replica``), a rolling checkpoint swap
  landing mid-drill: zero dropped or errored requests, the killed replica's
  sessions re-homed exactly once each, counted and visible, every client's
  ``fleet_version`` non-decreasing and reaching the swap, the kill counted
  as a kill and respawned, the health walking ok -> degraded/down -> ok.
- ``hang-replica`` (SIGSTOP): counted as a hang, not a kill, SIGKILLed and
  respawned while the survivor serves.
- A stateful replica's SIGTERM drain settles every admitted session step and
  exits 0.
- The ``serve_fleet`` verb end to end on a tiny SAC checkpoint: two replica
  processes, traffic through the router, SIGTERM, exit 0 everywhere.

Leases here are 2 s or more; nothing asserts on a sub-second lease or on an
exact spread."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.manager import CheckpointManager
from sheeprl_tpu_torch.fault.procsup import ProcessSupervisor
from sheeprl_tpu_torch.serve.fleet import FleetRouter, ReplicaEndpoint, free_port

REPO_ROOT = str(Path(__file__).resolve().parents[1])
REPLICA_MAIN = str(Path(__file__).resolve().parent / "torch_fleet_replica_main.py")
pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _inject_isolation():
    inject.reset()
    yield
    inject.reset()


def _wait(predicate, timeout=60.0, poll=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


def _spawner(port, extra=()):
    cmd = [sys.executable, REPLICA_MAIN, "--port", str(port), *extra]

    def spawn():
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    return spawn


class _Client:
    """One persistent JSON-lines connection."""

    def __init__(self, addr):
        self.sock = socket.create_connection(addr, timeout=60.0)
        self.rfile = self.sock.makefile("rb")

    def request(self, payload):
        self.sock.sendall((json.dumps(payload) + "\n").encode())
        line = self.rfile.readline()
        if not line:
            raise ConnectionResetError("the router closed the connection")
        return json.loads(line.decode())

    def close(self):
        self.rfile.close()
        self.sock.close()


def _stand_up(n, ckpt_dir, extra=(), lease_s=3.0):
    sup = ProcessSupervisor(lease_s=lease_s, grace_s=60.0, backoff=0.05, max_restarts=3, name="serve-fleet")
    endpoints = []
    for i in range(n):
        port = free_port()
        args = list(extra) + (["--watch", str(ckpt_dir)] if ckpt_dir is not None else [])
        sup.spawn(f"replica-{i}", _spawner(port, args))
        endpoints.append(ReplicaEndpoint(f"replica-{i}", "127.0.0.1", port, request_timeout_s=15.0))
    router = FleetRouter(endpoints, fleet_cfg={"health_poll_s": 0.05, "health_timeout_s": 2.0, "retry_budget": 3,
                                               "request_timeout_s": 15.0},
                         procsup=sup, owns_replicas=True, port=0).start()
    return router, sup, endpoints


def test_torch_fleet_chaos_kill_one_of_three_zero_dropped(tmp_path):
    ckpt_dir = tmp_path / "checkpoint"
    ckpt_dir.mkdir()
    router, sup, eps = _stand_up(3, ckpt_dir, extra=["--stateful"])
    try:
        assert router.wait_ready(timeout_s=120)
        addr = router.address
        statuses, sample_stop = [], threading.Event()

        def sampler():
            while not sample_stop.is_set():
                statuses.append(router.health()["status"])
                sample_stop.wait(0.05)

        threading.Thread(target=sampler, daemon=True).start()
        stop = threading.Event()
        errors = []
        stateless = [[] for _ in range(3)]  # (fleet_version, replica)
        sessions = [[] for _ in range(3)]  # (count, rehomed, replica, fleet_version)

        def client(i, session):
            c = _Client(addr)
            payload = {"obs": {"x": [[1.0, float(i)]]}, "n": 1}
            if session:
                payload["session_id"] = f"user-{i}"
            try:
                settle = 5
                while settle:
                    if stop.is_set():
                        settle -= 1  # a few requests after the drill
                    resp = c.request(payload)
                    if "error" in resp:
                        errors.append((i, session, resp["error"]))
                    elif session:
                        sessions[i].append((resp["actions"][0][0], bool(resp.get("rehomed")), resp["replica"],
                                            resp["fleet_version"]))
                    else:
                        stateless[i].append((resp["fleet_version"], resp["replica"]))
                    time.sleep(0.02)
            except Exception as e:  # a transport failure is a dropped request
                errors.append((i, session, repr(e)))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i, s)) for s in (False, True) for i in range(3)]
        for t in threads:
            t.start()
        assert _wait(lambda: all(len(r) >= 3 for r in sessions), timeout=30)
        homes = {f"user-{i}": sessions[i][-1][2] for i in range(3)}
        inject.arm_from_cfg({"fault": {"chaos": {"enabled": True, "seed": 7,
                                                 "events": ["serve.fleet.tick:kill-replica:20"]}}})
        assert _wait(lambda: sup.replica("replica-0").kills >= 1, timeout=30), sup.describe()
        CheckpointManager().save(ckpt_dir / "ckpt_10_0.ckpt", {"agent": {"w": 2 * torch.ones(2, 2)}}, step=10)
        assert _wait(lambda: router.health()["fleet"]["fleet_version"] >= 10, timeout=30)
        assert _wait(lambda: all(ep.ready and ep.step >= 10 for ep in eps), timeout=60), router.health()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sample_stop.set()
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        for rows in stateless:
            versions = [v for v, _ in rows]
            assert versions == sorted(versions) and versions[-1] >= 10
        rehomed = set()
        for i, rows in enumerate(sessions):
            versions = [v for *_, v in rows]
            assert versions == sorted(versions) and versions[-1] >= 10
            assert sum(r for _, r, _, _ in rows) <= 1
            expected = 0.0
            for count, was_rehomed, _, _ in rows:
                if was_rehomed:
                    expected = 0.0
                    rehomed.add(f"user-{i}")
                assert count == expected
                expected += 1.0
        victims = {sid for sid, home in homes.items() if home == "replica-0"}
        assert rehomed == victims
        health = router.health()
        assert health["fleet"]["sessions_rehomed"] == len(victims)
        handle = sup.replica("replica-0")
        assert handle.kills >= 1 and handle.hangs == 0 and handle.restarts >= 1 and handle.last_signal == "SIGKILL"
        assert statuses[0] == "ok" and ("degraded" in statuses or "down" in statuses)
        assert _wait(lambda: router.health()["status"] == "ok", timeout=30)
    finally:
        router.stop()
    assert all(not h.is_alive() for h in sup.replicas())


def test_torch_fleet_chaos_hang_replica_counted_as_hang_not_kill():
    router, sup, eps = _stand_up(2, None, lease_s=2.0)
    try:
        assert router.wait_ready(timeout_s=120)
        inject.arm_from_cfg({"fault": {"chaos": {"enabled": True, "events": ["serve.fleet.tick:hang-replica:5"]}}})
        assert _wait(lambda: any(h.hangs >= 1 for h in sup.replicas()), timeout=30), sup.describe()
        hung = next(h for h in sup.replicas() if h.hangs >= 1)
        assert hung.kills == 0  # a hang is not an outside kill
        for _ in range(10):
            resp = router.serve_request({"obs": {"x": [[1.0, 2.0]]}, "n": 1})
            assert "error" not in resp, resp
            time.sleep(0.05)
        assert _wait(lambda: all(ep.ready for ep in eps), timeout=60)
        assert hung.restarts >= 1
    finally:
        router.stop()


def test_torch_fleet_chaos_stateful_sigterm_drain_exits_zero():
    proc = subprocess.Popen([sys.executable, REPLICA_MAIN, "--port", "0", "--stateful", "--max-wait-ms", "5"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("REPLICA_READY"), line
        host, port = line.split()[1].rsplit(":", 1)
        results = {f"s{i}": [] for i in range(4)}

        def session(sid):
            c = _Client((host, int(port)))
            try:
                while True:
                    resp = c.request({"obs": {"x": [[1.0, 1.0]]}, "session_id": sid})
                    if "error" in resp:
                        return
                    results[sid].append(resp["actions"][0][0])
            except (OSError, ValueError):
                return
            finally:
                c.close()

        threads = [threading.Thread(target=session, args=(sid,)) for sid in results]
        for t in threads:
            t.start()
        assert _wait(lambda: all(len(r) >= 5 for r in results.values()), timeout=30)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        for t in threads:
            t.join(timeout=30)
        assert proc.returncode == 0 and "serve: drained cleanly" in out
        for counts in results.values():
            assert counts == [float(k) for k in range(len(counts))]  # contiguous to the last served step
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_torch_fleet_chaos_serve_fleet_verb_end_to_end(tmp_path):
    """``python -m sheeprl_tpu_torch serve_fleet`` on a tiny SAC checkpoint,
    on the CPU: two supervised replica processes behind the router, answers
    through it, then SIGTERM drains the router and both replicas to exit 0."""
    from tests.test_torch_flywheel import sac_checkpoint

    ckpt = sac_checkpoint(tmp_path)
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch", "serve_fleet", f"checkpoint_path={ckpt}",
                             "fabric.accelerator=cpu", "serve.fleet.replicas=2", f"serve.port={port}",
                             "serve.fleet.health_poll_s=0.1", "serve.log_every_s=600"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT, env=env,
                            start_new_session=True)
    try:
        def ready():
            try:
                c = _Client(("127.0.0.1", port))
                try:
                    return c.request({"health": True})["fleet"]["ready"] == 2
                finally:
                    c.close()
            except OSError:
                return False

        assert _wait(ready, timeout=120), "the fleet never became ready"
        c = _Client(("127.0.0.1", port))
        replicas = set()
        for i in range(6):
            resp = c.request({"obs": {"state": [[0.1 * i, 0.2, 0.3]]}, "n": 1})
            assert "actions" in resp and len(resp["actions"][0]) == 1, resp
            replicas.add(resp["replica"])
        c.close()
        assert replicas <= {"replica-0", "replica-1"}
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        try:  # the router and its replicas are one process group
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    assert proc.returncode == 0, out[-3000:]
    assert out.count("serve: drained cleanly") == 3  # the router and each replica
    final = json.loads([ln for ln in out.splitlines() if ln.startswith('{"status"')][-1])
    assert final["status"] == "draining" and final["fleet"]["routed"] == 6
    assert all(r["proc"]["last_rc"] == 0 for r in final["replicas"].values())
