"""The port's flywheel learner under supervision and chaos, on the CPU (JAX's
``tests/test_serve/test_flywheel.py`` supervision drills and
``tests/test_serve/test_flywheel_chaos.py``).

- A stand-in learner (a ``python -c`` child that rewrites the status file):
  SIGSTOP stops its beats, the lease expires, it is SIGKILLed and respawned,
  counted as a hang; ``kill-learner``/``hang-learner`` armed at the
  ``serve.flywheel.tick`` point act on the current learner, and ``stop()``
  clears them.
- End to end through the command line: ``serve --flywheel`` on a tiny SAC
  checkpoint spawns ``run --from-serve``; closed-loop clients grade the
  previous action; the learner trains, publishes, and the server adopts the
  published step; then the learner is SIGSTOPped (a counted hang, respawned)
  and SIGKILLed (a counted death, respawned) while no request errs; SIGTERM
  drains everything to exit 0.

Leases here are 2 s or more."""

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

from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.serve import flywheel as flywheel_mod
from sheeprl_tpu_torch.serve.fleet import free_port
from sheeprl_tpu_torch.serve.flywheel import LearnerSupervisor, read_learner_status

REPO_ROOT = str(Path(__file__).resolve().parents[1])
pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _inject_isolation():
    inject.reset()
    yield
    inject.reset()


def _wait(predicate, timeout=30.0, poll=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


def _fake_learner_cmd(status_dir):
    body = (
        "import json, os, time\n"
        f"d = {str(status_dir)!r}\n"
        "i = 0\n"
        "while True:\n"
        "    tmp = os.path.join(d, 'learner_status.json.tmp')\n"
        "    json.dump({'pid': os.getpid(), 'consumed_rows': i, 'grad_steps': i, 'published_step': -1}, open(tmp, 'w'))\n"
        "    os.replace(tmp, os.path.join(d, 'learner_status.json'))\n"
        "    i += 1\n"
        "    time.sleep(0.05)\n"
    )
    return [sys.executable, "-c", body]


def _supervisor(tmp_path, monkeypatch, **fly):
    monkeypatch.setattr(flywheel_mod, "learner_command", lambda cfg, d: _fake_learner_cmd(d))
    cfg = dotdict({"serve": {"flywheel": fly}, "checkpoint_path": "unused", "fabric": {"accelerator": "cpu"}})
    return LearnerSupervisor(cfg, tmp_path)


def _tick_until(sup, cond, timeout=30.0):
    return _wait(lambda: (sup.tick() or cond()), timeout=timeout)


def test_torch_flywheel_chaos_learner_lease_expiry_sigkills_and_respawns(tmp_path, monkeypatch):
    sup = _supervisor(tmp_path, monkeypatch, lease_s=2.0, grace_s=4.0,
                      supervisor={"max_restarts": 3, "backoff": 0.1})
    try:
        assert _tick_until(sup, lambda: sup.probe()["consumed_rows"] > 0)
        pid = sup.handle.pid()
        os.kill(pid, signal.SIGSTOP)  # the beats stop; serving would go on
        assert _tick_until(sup, lambda: sup.probe()["hangs"] == 1)
        assert _tick_until(sup, lambda: sup.probe()["alive"] and sup.handle.pid() != pid)
        probe = sup.probe()
        assert probe["restarts"] >= 1 and probe["kills"] == 0 and probe["fatal"] is None
        assert _tick_until(sup, lambda: (read_learner_status(tmp_path) or {}).get("pid") == sup.handle.pid())
    finally:
        sup.stop(grace_s=2.0)
    assert not sup.handle.is_alive()


def test_torch_flywheel_chaos_learner_handlers_armed_registered_and_cleared(tmp_path, monkeypatch):
    sup = _supervisor(tmp_path, monkeypatch, lease_s=5.0, grace_s=5.0, supervisor={"backoff": 0.1})
    try:
        assert inject._learner_chaos["kill"] is not None
        pid = sup.handle.pid()
        inject.arm("serve.flywheel.tick", action="kill-learner", at=1)
        sup.tick()  # the armed point SIGKILLs the current learner
        assert _tick_until(sup, lambda: sup.probe()["kills"] == 1)
        assert _tick_until(sup, lambda: sup.probe()["alive"] and sup.handle.pid() != pid)
        assert sup.probe()["deaths"] == 1 and sup.probe()["hangs"] == 0
    finally:
        sup.stop(grace_s=2.0)
    assert inject._learner_chaos == {"kill": None, "hang": None}


def _probe(addr):
    with socket.create_connection(addr, timeout=10.0) as s:
        s.sendall(b'{"health": true}\n')
        return json.loads(s.makefile("rb").readline())


def test_torch_flywheel_chaos_cli_end_to_end(tmp_path):
    from tests.test_torch_flywheel import sac_checkpoint

    ckpt = sac_checkpoint(tmp_path)
    port = free_port()
    addr = ("127.0.0.1", port)
    env = {**os.environ, "PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", "--flywheel", f"checkpoint_path={ckpt}",
         "fabric.accelerator=cpu", f"serve.port={port}", "serve.buckets=[1,4]", "serve.max_wait_ms=1.0",
         "serve.watch=True", "serve.watch_poll_s=0.2", "serve.log_every_s=600", "serve.flywheel.block_rows=8",
         "serve.flywheel.flush_s=0.1", "serve.flywheel.ingest_rows=4", "serve.flywheel.grad_max=2",
         "serve.flywheel.replay_ratio=1.0", "serve.flywheel.learning_starts_rows=8", "serve.flywheel.buffer_size=64",
         "serve.flywheel.publish_rows=16", "serve.flywheel.poll_s=0.1", "serve.flywheel.lease_s=3.0",
         "serve.flywheel.grace_s=60.0", "serve.flywheel.supervisor.backoff=0.1",
         "serve.flywheel.supervisor.max_restarts=10"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    stop, traffic = threading.Event(), {"requests": 0, "errors": [], "versions": []}
    out = ""
    try:
        assert _wait(lambda: proc.poll() is None and _try(lambda: _probe(addr)["ready"]), timeout=120), \
            "serve never became ready"

        def pump():
            with socket.create_connection(addr, timeout=60.0) as sock:
                rfile, turn = sock.makefile("rb"), 0
                while not stop.is_set():
                    payload = {"obs": {"state": [[0.1 * (turn % 7), 0.2, -0.3]]}, "n": 1}
                    if turn:
                        payload.update(reward=-1.0, done=1.0 if turn % 8 == 0 else 0.0)
                    sock.sendall((json.dumps(payload) + "\n").encode())
                    resp = json.loads(rfile.readline())
                    traffic["requests"] += 1
                    if "actions" not in resp:
                        traffic["errors"].append(resp)
                    else:
                        traffic["versions"].append(resp["version"])
                    turn += 1
                    time.sleep(0.01)

        thread = threading.Thread(target=pump, daemon=True)
        thread.start()

        def learner():
            return _probe(addr)["flywheel"].get("learner") or {}

        # the learner trains, publishes past the served step, and the server adopts it
        assert _wait(lambda: learner().get("published_step", -1) > 100, timeout=120), learner()
        assert _wait(lambda: _probe(addr)["weights"]["step"] > 100, timeout=60), _probe(addr)
        spool = Path(ckpt).parent / "flywheel"
        pid0 = int(read_learner_status(spool)["pid"])
        hangs0 = learner()["hangs"]
        os.kill(pid0, signal.SIGSTOP)
        assert _wait(lambda: learner()["hangs"] > hangs0, timeout=60), learner()
        assert _wait(lambda: (read_learner_status(spool) or {}).get("pid") not in (None, pid0)
                     and learner()["alive"], timeout=90), learner()
        pid1, deaths1 = int(read_learner_status(spool)["pid"]), learner()["deaths"]
        os.kill(pid1, signal.SIGKILL)
        assert _wait(lambda: learner()["deaths"] > deaths1, timeout=60), learner()
        assert _wait(lambda: (read_learner_status(spool) or {}).get("pid") not in (None, pid1)
                     and learner()["alive"], timeout=90), learner()
        stop.set()
        thread.join(timeout=30)
        final = _probe(addr)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        stop.set()
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            out = proc.communicate(timeout=30)[0]
        print(out[-6000:])  # shown when the test fails
    assert traffic["requests"] > 0 and traffic["errors"] == []
    assert traffic["versions"] == sorted(traffic["versions"]) and traffic["versions"][-1] >= 1
    lrn = final["flywheel"]["learner"]
    assert lrn["hangs"] >= 1 and lrn["kills"] >= 1 and lrn["restarts"] >= 2 and lrn["fatal"] is None
    assert final["flywheel"]["errors"] == 0 and final["flywheel"]["rows_logged"] > 0
    assert proc.returncode == 0, out[-4000:]
    assert "serve: drained cleanly" in out and "flywheel: published step" in out
    stats = json.loads([ln for ln in out.splitlines() if ln.startswith("{") and "Serve/requests" in ln][-1])
    assert stats["Serve/rejected"] == 0 and stats["Serve/requests"] >= traffic["requests"]


def _try(fn):
    try:
        return fn()
    except (OSError, ValueError):
        return False
