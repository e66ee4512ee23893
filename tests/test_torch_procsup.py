"""The port's process supervisor against the JAX package's, on the CPU.

Every drill runs twice, once through ``sheeprl_tpu.fault.procsup`` and once
through ``sheeprl_tpu_torch.fault.procsup``, on the same tiny child scripts
(``python -c``: a sleeper, a crasher that exits rc 3, and a child that
ignores SIGTERM), with an injected clock where time matters. Each drill
records the handles' counters and states (pids aside), the metric keys and
values, the warnings' texts and the typed error raised; the two records must
be equal. The drills are JAX's ``tests/test_fault/test_procsup.py``: a
SIGKILL counted as a kill and respawned, a plain exit counted as a death, a
missed lease counted as a hang and SIGKILLed, beats that keep a lease,
degrade past the budget then all dead, abort naming the replica, restart
ignoring the budget, the ``on_restart`` hook before the respawn, a retired
replica never respawned, the budget's off-by-one edge, exponential backoff,
a kill then a hang on one replica, and the drain's SIGTERM, grace, SIGKILL by
name.
"""

import os
import signal
import subprocess
import sys
import time
import warnings

import pytest

from sheeprl_tpu.fault import procsup as jax_procsup
from sheeprl_tpu.fault import supervisor as jax_supervisor
from sheeprl_tpu_torch.fault import procsup as port_procsup
from sheeprl_tpu_torch.fault import supervisor as port_supervisor

SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)"]
CRASHER = [sys.executable, "-c", "import sys; sys.exit(3)"]
STUBBORN = [sys.executable, "-c",
            "import signal, sys, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); print('ready', flush=True); "
            "time.sleep(120)"]

SIDES = {"jax": (jax_procsup, jax_supervisor), "port": (port_procsup, port_supervisor)}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _spawner(cmd, log=None, **popen):
    def spawn():
        if log is not None:
            log.append("spawn")
        return subprocess.Popen(cmd, **popen)

    return spawn


def _dead(handle, timeout=10.0):
    handle.proc.wait(timeout=timeout)


def _until(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return fn()


def _record(sup, rec):
    info = {name: {k: v for k, v in h.items() if k != "pid"} for name, h in sup.snapshot().items()}
    rec["snapshot"] = info
    rec["metrics"] = sup.metrics()
    rec["alive_count"] = sup.alive_count()
    return rec


def _checked(sup, rec, errors):
    try:
        sup.check()
    except errors as e:
        rec.setdefault("raised", []).append((type(e).__name__, str(e)))


def drill_sigkill(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=2)
    rec, log = {}, []
    h = sup.spawn("r0", _spawner(SLEEPER, log))
    os.kill(h.pid(), signal.SIGKILL)
    _dead(h)
    sup.check()  # detects the kill and, at zero backoff, respawns
    rec["alive_after"] = h.is_alive()
    rec["spawns"] = len(log)
    return sup, rec


def drill_plain_exit(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=60.0, max_restarts=2)
    h = sup.spawn("r0", _spawner(CRASHER))
    _dead(h)
    sup.check()
    return sup, {"state": h.state}


def drill_hang(mod, sup_mod):
    clock = _Clock()
    sup = mod.ProcessSupervisor(lease_s=5.0, grace_s=5.0, backoff=0.0, max_restarts=2, clock=clock)
    rec = {}
    h = sup.spawn("r0", _spawner(SLEEPER))
    first = h.proc
    clock.t += 10.0  # past the spawn grace, no beat
    sup.check()
    rec["first_rc"] = first.poll()  # SIGKILLed by the supervisor itself
    rec["respawned"] = h.is_alive() and h.proc is not first
    return sup, rec


def drill_beats(mod, sup_mod):
    clock = _Clock()
    sup = mod.ProcessSupervisor(lease_s=1.0, grace_s=1.0, backoff=0.0, clock=clock)
    h = sup.spawn("r0", _spawner(SLEEPER))
    for _ in range(6):
        clock.t += 0.5
        sup.beat("r0")
        sup.check()
    return sup, {"alive": h.is_alive()}


def drill_degrade_all_dead(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=0, escalation="degrade")
    rec = {}
    hs = [sup.spawn(f"r{i}", _spawner(CRASHER)) for i in range(2)]
    for h in hs:
        _dead(h)
    _checked(sup, rec, (sup_mod.AllWorkersDeadError,))
    return sup, rec


def drill_abort(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=0, escalation="abort")
    rec = {}
    h = sup.spawn("bad-replica", _spawner(CRASHER))
    _dead(h)
    _checked(sup, rec, (sup_mod.WorkerAbortError,))
    return sup, rec


def drill_restart_escalation(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=60.0, max_restarts=0, escalation="restart")
    h = sup.spawn("r0", _spawner(CRASHER))
    _dead(h)
    sup.check()
    return sup, {"state": h.state}


def drill_on_restart_order(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=2)
    order = []
    h = sup.spawn("r0", _spawner(SLEEPER, order), on_restart=lambda name: order.append(f"rehome:{name}"))
    os.kill(h.pid(), signal.SIGKILL)
    _dead(h)
    sup.check()
    return sup, {"order": order}


def drill_retired(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=2)
    h = sup.spawn("r0", _spawner(SLEEPER))
    h.retire()
    os.kill(h.pid(), signal.SIGKILL)
    _dead(h)
    sup.check()
    return sup, {"state": h.state}


def drill_budget_exhausted(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0, max_restarts=1, escalation="degrade")
    rec = {}
    h = sup.spawn("r0", _spawner(CRASHER))
    _dead(h)
    sup.check()  # death 1: within the budget, respawned at once
    _dead(h)
    _checked(sup, rec, (sup_mod.AllWorkersDeadError,))  # death 2: the budget exactly spent
    return sup, rec


def drill_backoff_growth(mod, sup_mod):
    clock = _Clock()
    sup = mod.ProcessSupervisor(lease_s=None, backoff=1.0, max_restarts=5, escalation="restart", clock=clock)
    rec = {"gates": []}
    h = sup.spawn("r0", _spawner(CRASHER))
    for _ in range(3):
        _dead(h)
        sup.check()
        rec["gates"].append(h._not_before - clock.t)
        clock.t = h._not_before
        sup.check()  # due: respawned (and the crasher dies again)
    return sup, rec


def drill_kill_then_hang(mod, sup_mod):
    clock = _Clock()
    sup = mod.ProcessSupervisor(lease_s=5.0, grace_s=5.0, backoff=0.0, max_restarts=4, clock=clock)
    h = sup.spawn("r0", _spawner(SLEEPER))
    os.kill(h.pid(), signal.SIGKILL)
    _dead(h)
    sup.check()
    os.kill(h.pid(), signal.SIGSTOP)
    clock.t += 100.0
    sup.check()
    return sup, {"alive": h.is_alive()}


def drill_drain_stubborn(mod, sup_mod):
    sup = mod.ProcessSupervisor(lease_s=None, backoff=0.0)
    good = sup.spawn("good", _spawner(SLEEPER))
    bad = sup.spawn("stubborn", _spawner(STUBBORN, stdout=subprocess.PIPE, text=True))
    assert bad.proc.stdout.readline().strip() == "ready"  # its SIG_IGN is installed
    killed = sup.terminate_all(grace_s=1.0)
    bad.proc.stdout.close()
    return sup, {"killed": killed, "alive": [good.is_alive(), bad.is_alive()]}


DRILLS = [drill_sigkill, drill_plain_exit, drill_hang, drill_beats, drill_degrade_all_dead, drill_abort,
          drill_restart_escalation, drill_on_restart_order, drill_retired, drill_budget_exhausted,
          drill_backoff_growth, drill_kill_then_hang, drill_drain_stubborn]


def _run(drill, side):
    mod, sup_mod = SIDES[side]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sup, rec = drill(mod, sup_mod)
        _record(sup, rec)
        sup.terminate_all(grace_s=5.0)
    rec["warnings"] = [str(w.message) for w in caught]
    return rec


@pytest.mark.parametrize("drill", DRILLS, ids=[d.__name__[len("drill_"):] for d in DRILLS])
def test_torch_procsup_drill_matches_jax(drill):
    want, got = _run(drill, "jax"), _run(drill, "port")
    assert got == want


def test_torch_procsup_drills_count_what_they_should():
    """The drills' records say what JAX's tests assert, on the port alone."""
    rec = _run(drill_sigkill, "port")
    r0 = rec["snapshot"]["r0"]
    assert (r0["kills"], r0["hangs"], r0["deaths"], r0["restarts"], r0["last_signal"]) == (1, 0, 1, 1, "SIGKILL")
    assert rec["alive_after"] and rec["spawns"] == 2
    assert r0["last_rc"] == -signal.SIGKILL
    rec = _run(drill_plain_exit, "port")
    assert rec["snapshot"]["r0"]["last_rc"] == 3 and rec["snapshot"]["r0"]["kills"] == 0
    assert any("exited rc=3" in w for w in rec["warnings"])
    rec = _run(drill_hang, "port")
    assert rec["snapshot"]["r0"]["hangs"] == 1 and rec["snapshot"]["r0"]["kills"] == 0
    assert rec["first_rc"] == -signal.SIGKILL and rec["respawned"]
    assert any("hung: missed its 5s health-probe lease" in w for w in rec["warnings"])
    assert _run(drill_beats, "port")["snapshot"]["r0"]["hangs"] == 0
    rec = _run(drill_degrade_all_dead, "port")
    assert rec["raised"][0][0] == "AllWorkersDeadError" and rec["alive_count"] == 0
    assert "bad-replica" in _run(drill_abort, "port")["raised"][0][1]
    assert _run(drill_restart_escalation, "port")["state"] == "backoff"
    assert _run(drill_on_restart_order, "port")["order"] == ["spawn", "rehome:r0", "spawn"]
    assert _run(drill_retired, "port")["snapshot"]["r0"]["restarts"] == 0
    rec = _run(drill_budget_exhausted, "port")
    assert rec["snapshot"]["r0"]["state"] == "degraded" and rec["snapshot"]["r0"]["restarts"] == 1
    assert _run(drill_backoff_growth, "port")["gates"] == [1.0, 2.0, 4.0]
    r0 = _run(drill_kill_then_hang, "port")["snapshot"]["r0"]
    assert (r0["kills"], r0["hangs"], r0["deaths"], r0["restarts"]) == (1, 1, 2, 2) and "hung" in r0["last_error"]
    rec = _run(drill_drain_stubborn, "port")
    assert rec["killed"] == ["stubborn"] and rec["alive"] == [False, False]
    assert any("SIGKILLed replica" in w and "stubborn" in w for w in rec["warnings"])
    assert set(rec["metrics"]) == {"Fleet/replica_deaths", "Fleet/replica_restarts", "Fleet/replica_hangs",
                                   "Fleet/replica_kills", "Fleet/replicas_live", "Fleet/replicas_degraded"}


@pytest.mark.parametrize("cfg, defaults", [
    ({"max_restarts": 5, "escalation": "abort", "lease_s": 0, "grace_s": 7.0}, {"backoff": 0.125, "name": "fleet-a"}),
    ({"lease_s": 3.0, "join_s": 2.0}, {"lease_s": 9.0, "max_restarts": 1}),
    ({}, {}),
], ids=["lease_off", "explicit_wins", "defaults"])
def test_torch_procsup_from_config_matches_jax(cfg, defaults):
    attrs = ("max_restarts", "backoff", "escalation", "lease_s", "grace_s", "join_s", "name")
    want = jax_procsup.ProcessSupervisor.from_config(dict(cfg), **defaults)
    got = port_procsup.ProcessSupervisor.from_config(dict(cfg), **defaults)
    assert {a: getattr(got, a) for a in attrs} == {a: getattr(want, a) for a in attrs}


def test_torch_procsup_unknown_escalation_raises():
    with pytest.raises(ValueError, match="escalation"):
        port_procsup.ProcessSupervisor.from_config({"escalation": "explode"})
