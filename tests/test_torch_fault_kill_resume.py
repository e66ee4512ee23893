"""A PPO run of the port on the CPU is SIGKILLed inside its third
checkpoint save (``SHEEPRL_FAULT_KILL=checkpoint.pre_commit:3``, after the
file is durable and before its rename) in a real subprocess, then relaunched
with ``checkpoint.resume_from=latest``: it resumes from the newest complete
checkpoint, skips the torn save, and reaches the counters of a run that was
never interrupted, as the JAX package's ``tests/test_fault/test_kill_resume.py``
drill does. Each run writes into its own ``<run_name>/version_N``
directory: the resumed run publishes its saves there and leaves the killed
run's directory as it was.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

from sheeprl_tpu_torch.fault import find_latest_run_checkpoint, latest_complete, read_manifest
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
ARGS = [
    "preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "buffer.size=8",
    "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.total_steps=96", "checkpoint.every=16",
    "algo.run_test=false", "metric.log_level=0", "seed=11",
]


def _launch(cwd: Path, *extra, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("SHEEPRL_FAULT_KILL", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "run", *ARGS, "log_root=logs", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_torch_fault_sigkill_mid_save_then_resume_from_latest(tmp_path):
    killed = _launch(tmp_path, env_extra={"SHEEPRL_FAULT_KILL": "checkpoint.pre_commit:3"})
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    (ckpt_dir,) = (tmp_path / "logs" / "ppo" / "CartPole-v1").glob("*_ppo_CartPole-v1_11/version_*/checkpoint")
    assert sorted(p.name for p in ckpt_dir.glob("*.ckpt")) == ["ckpt_16_0.ckpt", "ckpt_32_0.ckpt"]
    assert (ckpt_dir / "ckpt_48_0.ckpt.tmp").exists()  # the torn third save
    assert [e["step"] for e in read_manifest(ckpt_dir)] == [16, 32]
    assert latest_complete(ckpt_dir).name == "ckpt_32_0.ckpt"

    resumed = _launch(tmp_path, "checkpoint.resume_from=latest")
    assert resumed.returncode == 0, (resumed.stdout[-2000:], resumed.stderr[-2000:])
    killed_ckpt = (ckpt_dir / "ckpt_32_0.ckpt").relative_to(tmp_path).as_posix()
    assert f"checkpoint.resume_from=latest -> {killed_ckpt}" in resumed.stdout

    clean_dir = tmp_path / "clean"
    clean_dir.mkdir()
    clean = _launch(clean_dir)
    assert clean.returncode == 0, clean.stderr[-2000:]

    final = find_latest_run_checkpoint(tmp_path / "logs" / "ppo" / "CartPole-v1")
    want = load_checkpoint(find_latest_run_checkpoint(clean_dir / "logs" / "ppo" / "CartPole-v1"))
    state = load_checkpoint(final)
    assert final.name == "ckpt_96_0.ckpt"
    for key in ("iter_num", "last_checkpoint", "batch_size"):
        assert state[key] == want[key] == {"iter_num": 6, "last_checkpoint": 96, "batch_size": 8}[key]
    assert {int(s["step"]) for s in state["optimizer"]["state"].values()} == {6 * 2}
    assert all(torch.isfinite(v).all() for v in state["agent"].values())
    # the resumed run published its steps after the resume point into its own directory
    assert final.parent != ckpt_dir
    assert [e["step"] for e in read_manifest(final.parent)] == [48, 64, 80, 96]
    assert [e["step"] for e in read_manifest(ckpt_dir)] == [16, 32]
