"""Pod drills through the CLI on the CPU (the counterpart of the JAX
package's ``tests/test_parallel/test_pod.py`` drills): ``python -m
sheeprl_tpu_torch run --pod 2`` on a tiny PPO over the discrete counter env
with ``fabric.accelerator=cpu``.

- The fault-free twin: the pod finishes, both workers train every
  iteration, end with bit-equal parameters and the same gradient
  reductions, and the last checkpoint holds the run's final counters.
- ``kill-host``: a worker SIGKILLed mid-run at a progress-keyed chaos point
  makes the whole gang restart on a fresh coordinator port from the newest
  complete checkpoint, the step fences stay monotone, an MTTR is recorded,
  and the run ends on the twin's counters.

The recipe: 2 envs a worker x 32 steps (128 global steps an iteration), 10
epochs of 8 minibatches of 8 a rank, 10 iterations, a checkpoint every
iteration; the launcher polls every 0.05 s, so it sees each worker's every
step advance. Each drill has a time limit of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from sheeprl_tpu_torch.fault.manager import find_latest_run_checkpoint, load_resume_state

FINAL_ITERS = 10
OVERRIDES = [
    "preset=ppo", "env.id=discrete_dummy", "env.num_envs=2", "algo.rollout_steps=32", "algo.per_rank_batch_size=8",
    "algo.update_epochs=10", "algo.total_steps=1280", "checkpoint.every=128", "algo.run_test=False", "seed=11",
    "metric.log_level=0", "buffer.size=32", "fabric.accelerator=cpu", "fabric.pod.backoff=0.1",
    "fabric.pod.lease_s=20", "fabric.pod.tick_s=0.05",
]


def pod_run(tmp, tag, extra=(), timeout=150):
    """``run --pod 2`` with the drill's overrides; (rc, output)."""
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", "--pod", "2", *OVERRIDES, f"log_root={tmp}/{tag}",
           *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"pod run '{tag}' did not finish in {timeout}s:\n{out[-4000:]}")
    return proc.returncode, out


def summary(out):
    lines = [line for line in out.splitlines() if line.startswith("POD_SUMMARY ")]
    assert lines, f"no POD_SUMMARY in the output:\n{out[-4000:]}"
    return json.loads(lines[-1][len("POD_SUMMARY "):])


def workers(out):
    return [json.loads(line[len("POD_WORKER "):]) for line in out.splitlines() if line.startswith("POD_WORKER ")]


def final_state(tmp, tag):
    ckpt = find_latest_run_checkpoint(Path(str(tmp)) / tag / "ppo" / "discrete_dummy")
    assert ckpt is not None, f"no complete checkpoint for '{tag}'"
    return ckpt, load_resume_state(ckpt)


@pytest.fixture(scope="module")
def pod_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("pod_drills")


@pytest.fixture(scope="module")
def twin(pod_tmp):
    rc, out = pod_run(pod_tmp, "clean")
    return rc, out, summary(out), workers(out)


def test_torch_pod_drill_fault_free_pod_completes(twin, pod_tmp):
    rc, out, s, ranks = twin
    assert rc == 0, out[-4000:]
    assert s["finished"] and not s["drained"] and s["error"] is None
    assert s["pod_restarts"] == 0 and s["kills"] == 0 and s["hangs"] == 0 and s["fences"] == [0]
    ckpt, state = final_state(pod_tmp, "clean")
    assert state["iter_num"] == FINAL_ITERS and ckpt.name == f"ckpt_{FINAL_ITERS * 128}_0.ckpt"


def test_torch_pod_drill_fault_free_ranks_end_bit_equal(twin):
    _, _, _, ranks = twin
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["world_size"] == 2 and r["iterations"] == FINAL_ITERS for r in ranks)
    assert all(r["policy_steps"] == FINAL_ITERS * 128 for r in ranks)  # the counters count both workers' envs
    assert ranks[0]["param_digest"] == ranks[1]["param_digest"]
    # one reduction per minibatch: 10 epochs x 8 minibatches an iteration
    assert ranks[0]["reductions"] == ranks[1]["reductions"]
    assert ranks[0]["reductions"]["calls"] == FINAL_ITERS * 10 * 8


def test_torch_pod_drill_only_rank_zero_writes(pod_tmp):
    """One run directory per generation, rank 0's checkpoints only, a
    memmap directory per rank's name."""
    root = Path(str(pod_tmp)) / "clean" / "ppo" / "discrete_dummy"
    runs = [p for p in root.iterdir() if p.is_dir()]
    assert len(runs) == 1
    ckpts = sorted(p.name for p in (runs[0] / "version_0" / "checkpoint").glob("*.ckpt"))
    assert ckpts and all(name.endswith("_0.ckpt") for name in ckpts)
    assert not (runs[0] / "version_1").exists()


def test_torch_pod_drill_kill_host_gang_restarts_and_counters_match_twin(pod_tmp, twin):
    """SIGKILL one worker at the 6th observed step advance (iteration 3 of
    10): the gang restarts from the newest complete checkpoint on a fresh
    port and ends on the fault-free twin's counters, with no step lost or
    counted twice."""
    rc, out = pod_run(pod_tmp, "kill", extra=["fault.chaos.enabled=True",
                                              "fault.chaos.events=[train.pod.step:kill-host:6]"])
    s = summary(out)
    assert rc == 0, out[-4000:]
    assert "pod: chaos kill-host -> SIGKILL" in out
    assert s["finished"] and s["error"] is None
    assert s["pod_restarts"] >= 1 and s["kills"] >= 1 and s["hangs"] == 0
    assert s["fences"] == sorted(s["fences"]) and s["fences"][-1] > 0  # monotone, resumed from a checkpoint
    assert s["restarts"] and all(r["mttr_s"] > 0 for r in s["restarts"])
    ports = [line.rsplit(" ", 1)[1] for line in out.splitlines() if line.startswith("pod: launching")]
    assert ports and all(f"coordinator port {ports[0].split(':')[1]}" not in line
                         for line in out.splitlines() if line.startswith("pod: gang restart"))
    _, state = final_state(pod_tmp, "kill")
    _, twin_state = final_state(pod_tmp, "clean")
    for key in ("iter_num", "last_checkpoint", "train_step"):
        assert state[key] == twin_state[key], key
    ranks = workers(out)
    assert len(ranks) == 2 and ranks[0]["param_digest"] == ranks[1]["param_digest"]
    assert all(r["start_iter"] == s["fences"][-1] // 128 + 1 for r in ranks)
