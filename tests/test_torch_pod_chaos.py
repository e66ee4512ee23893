"""Pod chaos drills through the CLI on the CPU, beside
``tests/test_torch_pod_drill.py`` (same recipe): a SIGSTOPped worker
(``hang-host``) expires its heartbeat lease and is counted as a hang, apart
from the kills, and the gang restarts to completion; SIGTERM on the launcher
drains from the outside in: every worker checkpoints at its next iteration
boundary and exits 0, and the launcher reports a drained pod and exits 0.
Each drill has a time limit of its own.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from sheeprl_tpu_torch.fault.manager import find_latest_run_checkpoint, load_resume_state
from tests.test_torch_pod_drill import FINAL_ITERS, OVERRIDES, final_state, pod_run, summary, workers


@pytest.fixture(scope="module")
def pod_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("pod_chaos")


def test_torch_pod_chaos_hang_host_counts_apart_and_recovers(pod_tmp):
    rc, out = pod_run(pod_tmp, "hang", extra=["fabric.pod.lease_s=6", "fabric.pod.grace_s=90",
                                              "fault.chaos.enabled=True",
                                              "fault.chaos.events=[train.pod.step:hang-host:6]"], timeout=180)
    s = summary(out)
    assert rc == 0, out[-4000:]
    assert "pod: chaos hang-host -> SIGSTOP" in out
    assert s["finished"] and s["error"] is None
    assert s["hangs"] == 1  # the wedged worker is a hang, not a kill
    assert s["pod_restarts"] >= 1 and s["fences"] == sorted(s["fences"])
    _, state = final_state(pod_tmp, "hang")
    assert state["iter_num"] == FINAL_ITERS


def test_torch_pod_chaos_sigterm_drains_outermost_first(pod_tmp):
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", "--pod", "2", *OVERRIDES,
           "algo.total_steps=128000", f"log_root={pod_tmp}/drain"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    root = Path(str(pod_tmp)) / "drain" / "ppo" / "discrete_dummy"
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and find_latest_run_checkpoint(root) is None:
            assert proc.poll() is None, "the pod exited before its first checkpoint"
            time.sleep(0.2)
        assert find_latest_run_checkpoint(root) is not None, "no checkpoint within 90 s"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    s = summary(out)
    assert proc.returncode == 0, out[-4000:]
    assert s["drained"] and s["error"] is None and s["pod_restarts"] == 0 and s["kills"] == 0
    assert all(h["last_rc"] == 0 for h in s["workers_detail"].values())  # each worker exited on its own
    ranks = workers(out)
    assert len(ranks) == 2 and all(r["drained"] for r in ranks)
    assert ranks[0]["param_digest"] == ranks[1]["param_digest"]
    assert out.count("drain requested — checkpointed at policy_step=") == 2
    ckpt = find_latest_run_checkpoint(root)
    state = load_resume_state(ckpt)
    assert state["iter_num"] == ranks[0]["iterations"] < 1000  # the drain's checkpoint, long before the end
