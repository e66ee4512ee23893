"""The port's pod launcher and gang supervisor (``sheeprl_tpu_torch/parallel/pod.py``,
``sheeprl_tpu_torch/fault/podsup.py``) against the JAX package's unit tests of
them (``tests/test_parallel/test_pod.py``'s fast cases), on the CPU: the
launcher's pins (resume ownership, no recursion, the ``SHEEPRL_*``
variables, one device per worker), the gang restart's fresh port, resume
checkpoint and step fence, the worker helpers outside a pod, ``--pod``'s
parsing, the ``kill-host``/``hang-host`` chaos actions, and the gang ladder
on real (sleeping) processes: one death drains and respawns the whole gang,
a clean exit finishes it, the budget's end stops it with a typed error.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.manager import CheckpointManager
from sheeprl_tpu_torch.fault.podsup import PodSupervisor
from sheeprl_tpu_torch.fault.supervisor import AllWorkersDeadError, WorkerAbortError
from sheeprl_tpu_torch.parallel.pod import (
    STEP_POINT,
    TICK_POINT,
    PodLauncher,
    StepFenceError,
    beat_step,
    drain_requested,
    pod_worker_active,
)


def _cfg(tmp_path, **pod):
    return {"fabric": {"pod": {"workers": 2, "devices_per_worker": 1, **pod}}, "log_root": str(tmp_path / "logs"),
            "root_dir": "ppo/discrete_dummy"}


@pytest.fixture
def launcher(tmp_path):
    made = []

    def make(argv=(), **pod):
        made.append(PodLauncher(_cfg(tmp_path, **pod), list(argv)))
        return made[-1]

    yield make
    for launcher in made:
        import shutil

        shutil.rmtree(launcher.dir, ignore_errors=True)


@pytest.mark.parametrize("workers", [0, 1])
def test_torch_pod_launcher_rejects_fewer_than_two_workers(tmp_path, workers):
    with pytest.raises(ValueError, match=f"fabric.pod.workers >= 2, got {workers}"):
        PodLauncher(_cfg(tmp_path, workers=workers), [])


def test_torch_pod_launcher_one_device_per_worker(tmp_path):
    with pytest.raises(NotImplementedError, match=r"devices_per_worker=2: the port drives one device per process.*--pod 4"):
        PodLauncher(_cfg(tmp_path, devices_per_worker=2), [])


def test_torch_pod_launcher_worker_command_pins_and_resume_ownership(launcher):
    """The launcher owns the resume pin: the user's token leaves the workers'
    argv and comes back from the launcher (so a gang restart can replace
    it), and a worker never starts a pod of its own."""
    argv = ["preset=ppo", "checkpoint.resume_from=/old/ckpt", "algo.total_steps=64"]
    pod = launcher(argv)
    assert pod.user_resume == "/old/ckpt"
    cmd = pod.worker_command(0)
    assert cmd[:4] == [sys.executable, "-m", "sheeprl_tpu_torch", "run"]
    assert cmd.count("checkpoint.resume_from=/old/ckpt") == 1
    assert "fabric.pod.workers=0" in cmd and "algo.total_steps=64" in cmd
    assert not any(a.startswith("fabric.devices=") for a in cmd)  # one device a worker: nothing to pin


def test_torch_pod_launcher_worker_env_shape(launcher, monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    pod = launcher()
    env = pod.worker_env(1)
    assert env["SHEEPRL_COORDINATOR"] == f"127.0.0.1:{pod._port}"
    assert env["SHEEPRL_NUM_PROCESSES"] == "2" and env["SHEEPRL_PROCESS_ID"] == "1"
    assert env["SHEEPRL_POD_RANK"] == "1" and env["SHEEPRL_POD_HEARTBEAT"].endswith("heartbeat_1")
    assert float(env["SHEEPRL_POD_BEAT_S"]) == 30.0 / 4  # lease_s / 4 by default
    assert int(env["OMP_NUM_THREADS"]) == max(1, len(os.sched_getaffinity(0)) // 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert pod.worker_env(0)["OMP_NUM_THREADS"] == "3"  # the caller's own setting stands


def test_torch_pod_launcher_port_is_below_the_ephemeral_range(launcher):
    from sheeprl_tpu_torch.serve.fleet import _ephemeral_low

    assert launcher()._port < _ephemeral_low()


def test_torch_pod_launcher_gang_restart_resolves_latest_and_fences_monotone(launcher):
    pod = launcher(["preset=ppo"])
    ckpt_dir = Path(pod.ckpt_root) / "run_name" / "version_0" / "checkpoint"
    ckpt_dir.mkdir(parents=True)
    m = CheckpointManager()
    m.save(ckpt_dir / "ckpt_48_0.ckpt", {"agent": {"w": torch.ones(2)}, "iter_num": 3}, step=48)
    m.close()

    pod.fences.append(0)
    old_port = pod._port
    pod._on_gang_restart(2)
    assert pod.fences == [0, 48]
    assert pod._resume is not None and pod._resume.endswith("ckpt_48_0.ckpt")
    assert pod._port != old_port  # the dead coordinator may still hold its socket
    assert f"checkpoint.resume_from={pod._resume}" in pod.worker_command(0)
    assert pod._pending_restart["generation"] == 2 and pod._pending_restart["fence"] == 48

    import shutil

    shutil.rmtree(ckpt_dir)  # the checkpoint vanished: a fresh start at step 0, behind the fence
    with pytest.raises(StepFenceError, match="BEHIND the previous fence 48"):
        pod._on_gang_restart(3)


def test_torch_pod_launcher_gang_restart_without_checkpoint_starts_fresh(launcher):
    pod = launcher(["preset=ppo", "checkpoint.resume_from=/user/ckpt"])
    pod.fences.append(0)
    pod._on_gang_restart(2)
    assert pod.fences == [0, 0] and pod._resume == "/user/ckpt"


def test_torch_pod_launcher_worker_helpers_are_noops_outside_a_pod():
    assert not pod_worker_active()
    assert not drain_requested()
    beat_step(123)  # no heartbeat file bound: must not raise


def test_torch_pod_launcher_heartbeats_beat_and_count_step_advances(launcher):
    """An mtime change renews a worker's lease; a content change is a step
    advance, which fires ``train.pod.step`` and closes a pending MTTR
    window."""
    pod = launcher()
    beats = []
    pod.sup.beat = beats.append
    for rank in range(2):
        pod._hb_paths[rank].write_text("", encoding="utf-8")
        pod._hb_mtime[rank] = 0.0
        pod._hb_content[rank] = ""
    hits = []
    inject.reset()
    try:
        inject.set_host_chaos(kill=lambda: hits.append("kill"))
        inject.arm(STEP_POINT, action="kill-host", at=2)
        pod._pending_restart = {"generation": 2, "fault_t": time.monotonic() - 1.0, "respawn_t": time.monotonic()}
        pod._hb_paths[0].write_text("16", encoding="utf-8")
        pod._poll_heartbeats()
        assert "worker-0" in beats and hits == []
        assert pod.restart_log and pod.restart_log[0]["mttr_s"] >= 1.0
        pod._poll_heartbeats()  # no new content: no advance
        assert hits == []
        pod._hb_paths[1].write_text("16", encoding="utf-8")
        pod._poll_heartbeats()
        assert hits == ["kill"]  # the second advance
    finally:
        inject.reset()


def test_torch_pod_launcher_chaos_signals_a_live_worker(launcher):
    pod = launcher()
    procs = []
    try:
        pod.sup.spawn_gang({f"worker-{r}": lambda: procs.append(_sleeper()) or procs[-1] for r in range(2)})
        pod._chaos_hang()
        assert pod._fault_t is not None
        time.sleep(0.2)
        stat = Path(f"/proc/{procs[0].pid}/stat").read_text().split()[2]
        assert stat == "T"  # SIGSTOPped
        pod._chaos_kill()
        assert procs[0].wait(timeout=10) == -9
    finally:
        pod.sup.terminate_all(grace_s=1.0)


@pytest.mark.parametrize("action", ["kill-host", "hang-host"])
def test_torch_pod_launcher_host_chaos_dispatches(action):
    inject.reset()
    hits = []
    try:
        inject.set_host_chaos(kill=lambda: hits.append("kill"), hang=lambda: hits.append("hang"))
        inject.arm(TICK_POINT, action=action, at=2)
        inject.fault_point(TICK_POINT)
        assert hits == []
        inject.fault_point(TICK_POINT)  # the caller carries on
        assert hits == [action.split("-")[0]]
        inject.reset()  # clears the handlers too
        inject.arm(TICK_POINT, action=action, at=1)
        inject.fault_point(TICK_POINT)
        assert hits == [action.split("-")[0]]
    finally:
        inject.reset()


def test_torch_pod_launcher_host_chaos_arms_from_the_schedule():
    inject.reset()
    try:
        cfg = {"fault": {"chaos": {"enabled": True, "seed": 0, "events": ["train.pod.step:kill-host:6",
                                                                         "train.pod.tick:hang-host:3"]}}}
        assert inject.arm_from_cfg(cfg) == 2
        assert inject._armed[STEP_POINT][:2] == ("kill-host", 6)
        assert inject._armed[TICK_POINT][:2] == ("hang-host", 3)
    finally:
        inject.reset()


@pytest.mark.parametrize("argv,want", [
    (["run", "preset=ppo"], (["run", "preset=ppo"], None)),
    (["--pod", "preset=ppo"], (["preset=ppo"], 2)),
    (["--pod", "4", "preset=ppo"], (["preset=ppo"], 4)),
    (["--pod=3", "preset=ppo"], (["preset=ppo"], 3)),
    (["preset=ppo", "--pod"], (["preset=ppo"], 2)),
])
def test_torch_pod_launcher_cli_pod_flag_parsing(argv, want):
    assert cli._extract_pod_flag(argv) == want


# -- the gang ladder on real processes -----------------------------------------------


def _sleeper(seconds: float = 60.0, rc: int = 0) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", f"import time, sys; time.sleep({seconds}); sys.exit({rc})"])


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_torch_pod_launcher_gang_restart_drains_and_respawns_every_worker():
    restarts = []
    sup = PodSupervisor(backoff=0.0, drain_s=0.5, lease_s=None, name="t-pod",
                        on_gang_restart=restarts.append)
    procs = {}

    def spawner(name):
        def spawn():
            procs.setdefault(name, []).append(_sleeper())
            return procs[name][-1]
        return spawn

    try:
        sup.spawn_gang({"worker-0": spawner("worker-0"), "worker-1": spawner("worker-1")})
        assert sup.generation == 1
        procs["worker-1"][0].kill()
        assert _wait(lambda: (sup.check(), sup.pod_restarts)[1] == 1)
        assert restarts == [2] and sup.generation == 2
        assert procs["worker-0"][0].poll() is not None  # the survivor was drained
        assert len(procs["worker-0"]) == len(procs["worker-1"]) == 2  # the whole gang respawned
        info = sup.snapshot()
        assert info["worker-1"]["kills"] == 1 and info["worker-0"]["kills"] == 0
        assert sup.gang_info()["state"] == "idle"
    finally:
        sup.terminate_all(grace_s=1.0)


def test_torch_pod_launcher_clean_exits_finish_the_gang():
    sup = PodSupervisor(backoff=0.0, lease_s=None, name="t-pod")
    try:
        sup.spawn_gang({f"worker-{r}": lambda: _sleeper(0.2) for r in range(2)})
        assert _wait(lambda: (sup.check(), sup.finished())[1])
        assert sup.pod_restarts == 0 and all(h["deaths"] == 0 for h in sup.snapshot().values())
    finally:
        sup.terminate_all(grace_s=1.0)


@pytest.mark.parametrize("escalation,error", [("degrade", AllWorkersDeadError), ("abort", WorkerAbortError)])
def test_torch_pod_launcher_budget_end_raises_typed(escalation, error):
    sup = PodSupervisor(backoff=0.0, drain_s=0.2, lease_s=None, max_restarts=0, escalation=escalation, name="t-pod")
    try:
        sup.spawn_gang({"worker-0": lambda: _sleeper(), "worker-1": lambda: _sleeper(0.1, rc=3)})
        with pytest.raises(error):
            _wait(lambda: sup.check() and False, timeout=10)
        assert sup.pod_restarts == 0
    finally:
        sup.terminate_all(grace_s=1.0)


def test_torch_pod_launcher_hang_is_counted_apart_from_a_kill():
    """A silent worker past its lease is SIGKILLed by the supervisor and
    counted as a hang, not a kill, and the gang restarts."""
    clock = {"t": 0.0}
    sup = PodSupervisor(backoff=0.0, drain_s=0.5, lease_s=1.0, grace_s=0.0, name="t-pod",
                        clock=lambda: clock["t"])
    try:
        sup.spawn_gang({f"worker-{r}": lambda: _sleeper() for r in range(2)})
        clock["t"] = 0.5
        sup.beat("worker-0")
        clock["t"] = 1.2  # worker-1 missed its lease, worker-0 did not
        sup.check()
        info = sup.snapshot()
        assert info["worker-1"]["hangs"] == 1 and info["worker-1"]["kills"] == 0
        assert sup.pod_restarts == 0 and sup.gang_info()["state"] == "backoff"
        sup.check()
        assert sup.pod_restarts == 1 and sup.generation == 2
    finally:
        sup.terminate_all(grace_s=1.0)
