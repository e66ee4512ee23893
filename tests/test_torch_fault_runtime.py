"""The fault runtime through the port's ``run`` entry point, on the CPU: each
of the three trained families runs the finite guard by default (one verdict
per gradient step) and not with ``fault.sentinel.enabled=false``; the
resident DreamerV3 tier stays unguarded, as in the JAX package; a
DreamerV3 host-tier run with NaN rewards in its replay skips its steps and
keeps every parameter finite; ``checkpoint.resume_from=latest`` raises a
``CheckpointError`` when nothing is complete and resumes a checkpoint
written without a manager (no manifest, lazily created Adam state);
``RUN_DEFAULTS`` carries the JAX package's checkpoint and fault defaults;
and ``SHEEPRL_FAULT_ARM`` arms its fault points for a run.
"""

import importlib

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import RUN_DEFAULTS
from sheeprl_tpu_torch.fault import find_latest_run_checkpoint
from sheeprl_tpu_torch.utils.checkpoint import CheckpointError, load_checkpoint
from tests.test_torch_sac_loop import TINY as SAC_TINY
from tests.test_torch_train_loop import TINY_RUN as RSSM_TINY

PPO_TINY = [
    "preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "buffer.size=8",
    "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.total_steps=32", "metric.log_level=0",
    "algo.run_test=false",
]
RUNS = {
    "ppo": (PPO_TINY, "sheeprl_tpu_torch.algos.ppo.ppo"),
    "sac_per": (["preset=sac_per", *SAC_TINY, "algo.total_steps=48", "buffer.device_resident=true"],
                "sheeprl_tpu_torch.algos.sac.sac"),
    "sac": (["preset=sac", *SAC_TINY, "algo.total_steps=48"], "sheeprl_tpu_torch.algos.sac.sac"),
    "rssm_host": ([*RSSM_TINY, "algo.total_steps=12", "algo.run_test=false"],
                  "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3"),
    "rssm_resident": ([*RSSM_TINY, "algo.total_steps=12", "algo.run_test=false", "buffer.device_resident=true"],
                      "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counting_guard(monkeypatch, module_name):
    module = importlib.import_module(module_name)
    real, verdicts = module.finite_guard, []

    def counting(tensors):
        ok = real(tensors)
        verdicts.append(ok)
        return ok

    monkeypatch.setattr(module, "finite_guard", counting)
    return verdicts


@pytest.mark.parametrize("enabled", [True, False], ids=["default", "sentinel-off"])
@pytest.mark.parametrize("run", list(RUNS))
def test_torch_fault_runtime_guards_every_gradient_step_by_default(tmp_path, monkeypatch, run, enabled):
    args, module_name = RUNS[run]
    verdicts = _counting_guard(monkeypatch, module_name)
    extra = [] if enabled else ["fault.sentinel.enabled=false"]
    s = cli.run([*args, f"log_root={tmp_path}", *extra])
    steps = s["gradient_steps"] if "gradient_steps" in s else s["iterations"] * 2
    assert steps > 0
    guarded = enabled and run != "rssm_resident"
    assert len(verdicts) == (steps if guarded else 0)
    assert all(bool(ok) for ok in verdicts) and s["Fault/skipped_updates"] == 0.0
    assert s["checkpoint_timings"] and s["Fault/env_restarts"] == 0


def test_torch_fault_runtime_rssm_host_run_skips_nan_reward_steps(tmp_path, monkeypatch):
    """Every reward NaN: each gradient step's losses are not finite, the
    guard undoes all of them, and the checkpoint's modules and moments stay
    finite (the default sentinel warns at each bad iteration and, with no
    complete checkpoint before the first train call, the third bad one in a
    row would abort: max_consecutive is raised to let the run finish)."""
    from sheeprl_tpu_torch.envs.dummy import AtariProtocolDummyEnv

    real_step = AtariProtocolDummyEnv.step

    def nan_reward(self, action):
        obs, _, term, trunc, info = real_step(self, action)
        return obs, float("nan"), term, trunc, info

    monkeypatch.setattr(AtariProtocolDummyEnv, "step", nan_reward)
    with pytest.warns(UserWarning, match="optimizer update\\(s\\) skipped"):
        s = cli.run([*RSSM_TINY, "algo.total_steps=12", "algo.run_test=false", f"log_root={tmp_path}",
                     "fault.sentinel.max_consecutive=100"])
    assert s["gradient_steps"] > 0 and s["Fault/skipped_updates"] == s["gradient_steps"]
    assert all(np.isnan(row[2]) for row in s["metrics"])  # the reward loss
    state = load_checkpoint(s["checkpoint"])
    for name in ("world_model", "actor", "critic", "target_critic"):
        assert all(torch.isfinite(v).all() for v in state[name].values()), name
    assert all(torch.isfinite(v) for v in state["moments"].values())
    steps = {int(st["step"]) for opt in state["optimizers"].values() for st in opt["state"].values()}
    assert steps == {0}


def test_torch_fault_runtime_resume_latest_needs_a_complete_checkpoint(tmp_path):
    with pytest.raises(CheckpointError, match="no complete checkpoint found under"):
        cli.run([*PPO_TINY, f"log_root={tmp_path}", "checkpoint.resume_from=latest"])


def test_torch_fault_runtime_resume_latest_reads_a_checkpoint_without_a_manifest(tmp_path):
    """A checkpoint of the port's earlier format: no manifest beside it and
    Adam's state as torch creates it at the first step (no capturable flag
    in its groups). ``latest`` finds it by the scan and resumes from it."""
    first = cli.run([*PPO_TINY, f"log_root={tmp_path}", "checkpoint.every=0"])
    ckpt = find_latest_run_checkpoint(tmp_path / "ppo" / "CartPole-v1")
    (ckpt.parent / "manifest.json").unlink()
    state = load_checkpoint(ckpt)
    for group in state["optimizer"]["param_groups"]:
        group.pop("capturable")
    torch.save(state, ckpt)
    resumed = cli.run([*PPO_TINY, f"log_root={tmp_path}", "checkpoint.resume_from=latest", "algo.total_steps=48"])
    assert resumed["start_iter"] == first["iterations"] + 1 == 3 and resumed["iterations"] == 1
    after = load_checkpoint(resumed["checkpoint"])
    assert {int(s["step"]) for s in after["optimizer"]["state"].values()} == {3 * 2}


def test_torch_fault_runtime_defaults_are_the_jax_package_s():
    jax_cfg = compose(["exp=ppo"])
    for key in ("every", "save_last", "keep_last", "async_save"):
        assert RUN_DEFAULTS["checkpoint"][key] == jax_cfg.checkpoint[key], key
    for key in ("enabled", "max_consecutive", "action"):
        assert RUN_DEFAULTS["fault"]["sentinel"][key] == jax_cfg.fault.sentinel[key], key
    assert RUN_DEFAULTS["fault"]["inject"]["nan_grads_at"] == list(jax_cfg.fault.inject.nan_grads_at)
    for key in ("restart_attempts", "restart_backoff", "step_timeout"):
        assert RUN_DEFAULTS["env"][key] == jax_cfg.env[key], key


def test_torch_fault_runtime_arm_variable_reaches_the_run(tmp_path, monkeypatch):
    """``SHEEPRL_FAULT_ARM`` arms its points when ``run`` starts: a raise at
    the second save's ``checkpoint.pre_commit`` stops the run with the first
    checkpoint published and the second never committed."""
    from sheeprl_tpu_torch.fault import inject, read_manifest

    monkeypatch.setenv(inject.ARM_ENV_VAR, "checkpoint.pre_commit:raise:2")
    try:
        with pytest.raises(inject.FaultInjected, match="checkpoint.pre_commit"):
            cli.run([*PPO_TINY, f"log_root={tmp_path}", "checkpoint.every=16"])
    finally:
        inject.reset()
    (ckpt_dir,) = (tmp_path / "ppo" / "CartPole-v1").glob("*/version_0/checkpoint")
    assert [e["step"] for e in read_manifest(ckpt_dir)] == [16]
    assert sorted(p.name for p in ckpt_dir.glob("*.ckpt*")) == ["ckpt_16_0.ckpt"]
