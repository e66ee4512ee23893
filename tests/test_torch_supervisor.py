"""The port's thread ``Supervisor`` against the JAX package's
(``sheeprl_tpu/fault/supervisor.py``): the same scripted crashes, hangs and
stops, on one fake clock, give equal snapshots, counters, warnings and
typed errors at every step, under each escalation policy; the supervised
scheduler loses no admitted request when its worker dies mid-batch."""

import time
import warnings

import numpy as np
import pytest

from sheeprl_tpu.fault import supervisor as jax_sup
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault import supervisor as port_sup

MODULES = {"port": port_sup, "jax": jax_sup}


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _crasher(fuse):
    """Raises while ``fuse`` holds failures, then idles until cancelled."""

    def target(ctx):
        if fuse[0] > 0:
            fuse[0] -= 1
            raise RuntimeError(f"boom {fuse[0]}")
        while not ctx.cancelled:
            time.sleep(0.005)

    return target


def _sleeper(ctx):
    """Never beats: its lease runs out on the fake clock alone."""
    while not ctx.cancelled:
        time.sleep(0.005)


def _wait_dead(handle):
    handle.thread.join(timeout=10)
    assert not handle.thread.is_alive()


def _drive(mod, escalation):
    clock = _Clock()
    sup = mod.Supervisor(max_restarts=2, backoff=0.5, escalation=escalation, lease_s=10.0, grace_s=0.0,
                         join_s=5.0, name="drill", clock=clock)
    trace = []
    fuse = [3]  # three crashes; a fourth generation idles
    onr = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = sup.spawn("a", _crasher(fuse), on_restart=lambda ctx: onr.append(ctx.generation))
        b = sup.spawn("b", _sleeper)  # its 10 s lease runs from the spawn
        sup.spawn("c", _sleeper, lease_s=None)

        def step(label, advance=0.0):
            clock.now += advance
            try:
                sup.check()
                err = None
            except mod.SupervisionError as e:
                err = f"{type(e).__name__}: {e}"
            snap = sup.snapshot()
            trace.append((label, snap, sup.alive_count(), sup.metrics(prefix="P/", noun="w"), err,
                          [str(w.message) for w in caught]))
            caught.clear()
            return err

        _wait_dead(a)
        step("a died")  # restart scheduled with backoff 0.5
        step("backoff not due", 0.25)
        step("restart due", 0.3)
        _wait_dead(a)
        step("a died again")
        step("second restart", 1.1)
        _wait_dead(a)
        if step("a past its budget") is None:
            step("b silent, lease running", 8.0)  # 9.65 s after the spawn
            step("b hung", 1.0)  # 10.65 s: past the lease; c has none
            step("b restart due", 0.6)
            b.retire()
            step("b retired")
        sup.join(budget_s=5.0)
        trace.append(("joined", sup.snapshot(), sup.alive_count(), None, None, [str(w.message) for w in caught]))
    trace.append(("on_restart generations", onr))
    return trace


def _normalise(trace):
    """Thread liveness right after a spawn is a race of the scheduler, not
    of the supervisor: compare it only where the state says it is settled."""
    out = []
    for row in trace:
        if len(row) == 6:
            label, snap, live, metrics, err, warned = row
            snap = {k: {**v, "alive": v["alive"] if v["state"] in ("degraded", "stopped") else None}
                    for k, v in snap.items()}
            out.append((label, snap, live, metrics, err, warned))
        else:
            out.append(row)
    return out


@pytest.mark.parametrize("escalation", ["degrade", "restart", "abort"])
def test_torch_supervisor_snapshots_equal_jax_under_scripted_faults(escalation):
    port, jax = _drive(port_sup, escalation), _drive(jax_sup, escalation)
    assert _normalise(port) == _normalise(jax)
    final = dict((row[0], row[1]) for row in port if len(row) == 6)
    if escalation == "abort":
        assert "WorkerAbortError" in port[5][4]
    else:
        restarts = final["joined"]["a"]["restarts"]
        assert restarts == (3 if escalation == "restart" else 2)  # restart: the fourth generation idles
        assert final["b hung"]["b"]["hangs"] == 1 and final["b restart due"]["b"]["generation"] == 2


@pytest.mark.parametrize("name", list(MODULES))
def test_torch_supervisor_from_config_as_jax(name):
    mod = MODULES[name]
    sup = mod.Supervisor.from_config({"max_restarts": 5, "lease_s": None, "escalation": "restart"}, backoff=0.1,
                                     max_restarts=1)
    assert (sup.max_restarts, sup.backoff, sup.escalation, sup.lease_s) == (5, 0.1, "restart", None)
    off = mod.Supervisor.from_config({"enabled": False})
    assert (off.max_restarts, off.escalation) == (0, "abort")
    with pytest.raises(ValueError, match="Unknown fault.supervisor.escalation 'sometimes'"):
        mod.Supervisor(escalation="sometimes")
    with pytest.raises(ValueError, match="worker 'x' is already supervised"):
        sup.spawn("x", lambda ctx: None)
        sup.spawn("x", lambda ctx: None)
    sup.join(budget_s=2.0)


def test_torch_supervisor_all_dead_raises_the_typed_error():
    for mod in (port_sup, jax_sup):
        sup = mod.Supervisor(max_restarts=0, escalation="degrade", lease_s=None)
        h = sup.spawn("only", _crasher([1]))
        _wait_dead(h)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(mod.AllWorkersDeadError, match="all supervised workers are dead \\(only: RuntimeError"):
                sup.check()
        sup.join(budget_s=1.0)


class _SlowEngine:
    """A stateless engine stand-in: the action of a row is its observation."""

    buckets = (8,)
    greedy = True
    device = None

    class policy:
        @staticmethod
        def validate_batch(obs):
            return int(obs["x"].shape[0])

    def infer(self, params, obs, key=None):
        return np.asarray(obs["x"]) * params


def test_torch_supervisor_scheduler_recovers_the_batch_of_a_dead_worker():
    """The scheduler's worker dies at ``serve.scheduler.batch`` with a batch
    admitted; the supervisor restarts it and the new generation serves that
    batch first: every request resolves, none twice."""
    import torch

    from sheeprl_tpu_torch.serve.scheduler import RequestScheduler
    from sheeprl_tpu_torch.serve.weights import WeightStore

    engine = _SlowEngine()
    engine.device = torch.device("cpu")
    sup = port_sup.Supervisor(max_restarts=2, backoff=0.0, lease_s=None, name="serve")
    sched = RequestScheduler(engine, WeightStore(2.0), max_wait_s=0.05, max_batch=8)
    inject.arm("serve.scheduler.batch", "raise", at=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sched.start(supervisor=sup)
            sup.start_monitor(poll_s=0.05)
            reqs = [sched.submit({"x": np.full((1, 1), float(i))}) for i in range(6)]
            got = [sched.result(r, timeout=10)[0] for r in reqs]
            assert [float(a[0, 0]) for a in got] == [2.0 * i for i in range(6)]
            snap = sup.snapshot()["serve-scheduler"]
            assert snap["restarts"] == 1 and snap["deaths"] == 1 and "FaultInjected" in snap["last_error"]
            assert sched.worker_alive()
    finally:
        inject.reset()
        sup.request_stop()
        sup.stop_monitor()
        sched.stop()
    assert not sched.worker_alive()
