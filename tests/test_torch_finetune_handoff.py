"""Plan2Explore through the port's entry points on the CPU, at tiny widths of
``preset=p2e_dv3_exploration_atari_dummy`` and
``preset=p2e_dv3_finetuning_atari_dummy``:

- the presets are the JAX package's ``exp=p2e_dv3_exploration`` and
  ``exp=p2e_dv3_finetuning`` on ``env=atari_dummy`` at DreamerV3-S widths
  for every key both name, bar the cuts their ``preset`` blocks list;
- an exploration run trains every module, logs the JAX exploration metric
  keys to ``metrics.jsonl``, checkpoints every module, optimizer and
  ``Moments`` state and the buffer, and resumes (by path and with
  ``resume_from=latest``);
- ``python -m sheeprl_tpu_torch run preset=p2e_dv3_finetuning_atari_dummy
  checkpoint.exploration_ckpt_path=<ckpt>`` starts from it: another env id
  raises; the exploration run's env keys (the CLI's) and model keys (the
  loop's) win over the finetuning run's; ``buffer.load_from_exploration``
  takes its buffer and its ``num_envs``; the player switches to the task
  actor at the first granted gradient step; the world model and task actor
  start as the exploration left them;
- ``evaluation`` of either checkpoint is the run's own test episode (the
  task actor's, sampled from the run's seed).
"""

import json
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning
from sheeprl_tpu_torch.algos.p2e_dv3.agent import STATE_KEYS
from sheeprl_tpu_torch.config import load_config, preset
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from tests.test_torch_dry_run import EXPLORE_WIDTHS
from tests.test_torch_sac_loop import _leaves

TINY = ["fabric.accelerator=cpu", "metric.log_level=1", "metric.log_every=8", "algo.learning_starts=8",
        "algo.replay_ratio=0.5", "buffer.size=512", "buffer.memmap=false", "checkpoint.every=0",
        "checkpoint.save_last=true", "algo.per_rank_sequence_length=4"] + [
    o for o in EXPLORE_WIDTHS if not o.startswith(("algo.per_rank_sequence_length", "algo.run_test", "metric."))]
#: what the presets set otherwise than the JAX recipe, on purpose (their ``preset`` blocks)
SUBSTITUTED_PREFIXES = ("algo.dense_units", "algo.mlp_layers", "algo.world_model.", "algo.actor.", "algo.critic.",
                        "algo.ensembles.dense_units", "algo.ensembles.mlp_layers", "buffer.size", "env.num_envs",
                        "algo.total_steps", "checkpoint.", "seed", "metric.log_every", "buffer.device_resident",
                        "env.max_episode_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("phase", ["exploration", "finetuning"])
def test_torch_finetune_presets_are_the_jax_recipes(phase):
    port = preset(f"p2e_dv3_{phase}_atari_dummy")
    assert port.preset.composition == f"exp=p2e_dv3_{phase} env=atari_dummy"
    overrides = ["checkpoint.exploration_ckpt_path=x"] if phase == "finetuning" else []
    jax_cfg = compose([f"exp=p2e_dv3_{phase}", "env=atari_dummy"] + overrides)
    checked = 0
    for path, value in _leaves(port):
        if path.startswith("preset.") or path.startswith(SUBSTITUTED_PREFIXES) or path.startswith("metric.aggregator"):
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        want = node.rsplit(".", 1)[-1] if path.endswith("_target_") else node
        assert value == want, path
        checked += 1
    assert checked >= 25
    assert port.algo.ensembles.n == 8 and port.algo.per_rank_batch_size == 16
    assert port.algo.per_rank_sequence_length == 64 and port.algo.horizon == 15 and port.buffer.size == 100000
    assert set(port.metric.aggregator.metrics) == set(jax_cfg.metric.aggregator.metrics) - {
        "Rewards/rew_avg", "Game/ep_len_avg"}


@pytest.fixture(scope="module")
def explored(tmp_path_factory):
    root = tmp_path_factory.mktemp("explore")
    s = cli.run(["preset=p2e_dv3_exploration_atari_dummy", f"log_root={root}", "algo.total_steps=24",
                 "run_name=explore"] + TINY)
    return root, s


def test_torch_finetune_exploration_run_trains_checkpoints_and_logs(explored):
    root, s = explored
    assert s["policy_steps"] == 24 and s["gradient_steps"] > 0 and s["player_steps"] > 0
    assert np.isfinite(np.asarray(s["metrics"])).all()
    state = load_checkpoint(s["checkpoint"])
    assert set(state) == set(STATE_KEYS) | {"optimizers", "moments", "ratio", "iter_num", "batch_size", "last_log",
                                            "last_checkpoint", "train_step", "last_train", "rng", "rb"}
    assert set(state["optimizers"]) == {"world", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                        "critic_exploration_extrinsic", "critic_exploration_intrinsic"}
    assert set(state["moments"]["exploration"]) == {"extrinsic", "intrinsic"}
    logged = {k for line in open(os.path.join(s["log_dir"], "metrics.jsonl")) for k in json.loads(line)}
    for key in ("Loss/ensemble_loss", "Loss/policy_loss_exploration", "Rewards/intrinsic", "Loss/value_loss_intrinsic",
                "Loss/value_loss_extrinsic", "Loss/policy_loss_task", "Loss/value_loss_task", "Loss/world_model_loss"):
        assert key in logged, key


def test_torch_finetune_exploration_resumes(explored):
    root, s = explored
    # 2 envs: the run ended at iteration 12; "latest" then finds the first resume's save at 20
    for resume, start, total in ((s["checkpoint"], 13, 40), ("latest", 21, 48)):
        extra = ["preset=p2e_dv3_exploration_atari_dummy"] if resume == "latest" else []
        r = cli.run(extra + [f"checkpoint.resume_from={resume}", "fabric.accelerator=cpu", "metric.log_level=0",
                             f"log_root={root}", "algo.learning_starts=4", f"algo.total_steps={total}"])
        assert r["start_iter"] == start and r["policy_steps"] == total and r["gradient_steps"] > 0
        state = load_checkpoint(r["checkpoint"])
        assert state["iter_num"] == total // 2 and np.isfinite(np.asarray(r["metrics"])).all()


def test_torch_finetune_hands_off_through_the_cli(explored, tmp_path, monkeypatch):
    _, s = explored
    base = ["run", "preset=p2e_dv3_finetuning_atari_dummy", f"log_root={tmp_path}",
            f"checkpoint.exploration_ckpt_path={s['checkpoint']}"] + TINY
    with pytest.raises(ValueError, match="different environment"):
        cli.main(base + ["env.id=continuous_dummy"])
    seen = []
    main = p2e_dv3_finetuning.main
    monkeypatch.setattr(p2e_dv3_finetuning, "main", lambda cfg, device: seen.extend([main(cfg, device), cfg]))
    cli.main(base + ["algo.total_steps=16", "env.action_repeat=2", "env.num_envs=1", "algo.horizon=7",
                     "buffer.load_from_exploration=true"])
    f, cfg = seen
    assert cfg.env.action_repeat == 4 and cfg.algo.horizon == 3  # the exploration run's env and model keys
    assert cfg.env.num_envs == 2  # the exploration's buffer comes with its env count
    assert f["switched_at"] == 8  # the first granted step: learning_starts 8 at 2 envs a step
    assert f["gradient_steps"] > 0 and np.isfinite(np.asarray(f["metrics"])).all()
    state = load_checkpoint(f["checkpoint"])
    assert set(state["optimizers"]) == {"world", "actor", "critic"}
    assert set(state["moments"]) == {"low", "high"}
    explored_rb = load_checkpoint(s["checkpoint"])["rb"]
    first_rows = state["rb"]["envs"][0]["buffer"]["rgb"][:4]
    torch.testing.assert_close(first_rows, explored_rb["envs"][0]["buffer"]["rgb"][:4])


def test_torch_finetune_starts_from_the_exploration_weights(explored, tmp_path):
    _, s = explored
    f = cli.run(["preset=p2e_dv3_finetuning_atari_dummy", f"log_root={tmp_path}", "algo.total_steps=4",
                 f"checkpoint.exploration_ckpt_path={s['checkpoint']}"] + TINY)
    assert f["gradient_steps"] == 0 and f["switched_at"] is None  # within learning_starts: the exploration actor
    explored_state, state = load_checkpoint(s["checkpoint"]), load_checkpoint(f["checkpoint"])
    for key in ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration"):
        for name, value in explored_state[key].items():
            torch.testing.assert_close(state[key][name], value, rtol=0, atol=0, msg=f"{key}.{name}")


def test_torch_finetune_evaluation_of_both_checkpoints_is_the_run_test(explored, tmp_path):
    _, s = explored
    f = cli.run(["preset=p2e_dv3_finetuning_atari_dummy", f"log_root={tmp_path}", "algo.total_steps=16",
                 f"checkpoint.exploration_ckpt_path={s['checkpoint']}"] + TINY)
    for run in (s, f):
        evaluated = cli.evaluation([f"checkpoint_path={run['checkpoint']}", "fabric.accelerator=cpu"])
        assert evaluated == {"reward": run["test_reward"], "steps": run["test_steps"], "device": "cpu"}
        assert evaluated["steps"] > 0
    assert load_config(find_run_config(f["checkpoint"])).algo.name == "p2e_dv3_finetuning"
    rows = {r["name"]: r for r in cli.agents()}
    for name in ("p2e_dv3_exploration", "p2e_dv3_finetuning"):
        assert rows[name]["trainer"] and rows[name]["evaluation"] and not rows[name]["serving"]
