"""Plan2Explore on Dreamer V1 through the port's entry points on the CPU, at
tiny widths of ``preset=p2e_dv1_exploration_atari_dummy`` and
``preset=p2e_dv1_finetuning_atari_dummy``:

- both presets are the JAX package's recipes (``exp=p2e_dv1_*``) on
  ``env=atari_dummy``, full width, for every key both name, bar the cuts and
  stand-ins their ``preset`` blocks list;
- an exploration run trains every module, checkpoints every module (no
  target critics in V1), optimizer and the buffer, and resumes from exactly
  that buffer;
- ``run preset=p2e_dv1_finetuning_atari_dummy
  checkpoint.exploration_ckpt_path=<ckpt> buffer.load_from_exploration=true``
  starts from it: the exploration run's model keys win; the exploration's
  buffer and ``num_envs`` are taken; the player acts with the exploration
  actor until the first granted gradient step and then with the task
  actor; the world model and task actor start as the exploration left
  them; another env id raises;
- ``evaluation`` of either checkpoint is the run's own greedy test episode
  of the task actor;
- ``dry_run=true`` of both presets trains one step on a one-row sequence.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning
from sheeprl_tpu_torch.algos.p2e_dv1.agent import STATE_KEYS
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_rssm_v1_loop import TINY
from tests.test_torch_sac_loop import _leaves

EXPLORE = TINY + ["algo.learning_starts=16", "algo.replay_ratio=0.25", "algo.per_rank_pretrain_steps=0",
                  "buffer.memmap=false", "checkpoint.every=0", "checkpoint.save_last=true"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("phase", ["exploration", "finetuning"])
def test_torch_finetune_v1_presets_are_the_jax_recipes(phase):
    port = preset(f"p2e_dv1_{phase}_atari_dummy")
    exp = f"exp=p2e_dv1_{phase}"
    assert port.preset.composition == f"{exp} env=atari_dummy"
    jax_cfg = compose([exp, "env=atari_dummy", "checkpoint.exploration_ckpt_path=x"])
    checked = 0
    for path, value in _leaves(port):
        if path.startswith(("preset.", "metric.aggregator", "buffer.size", "env.id", "checkpoint.exploration")):
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        want = node.rsplit(".", 1)[-1] if path.endswith("_target_") else node
        assert value == want, path
        checked += 1
    assert checked >= 60
    assert port.buffer.size == 100000 and jax_cfg.buffer.size == 5000000
    assert any("buffer.size" in r for r in port.preset.reduced)
    assert set(port.metric.aggregator.metrics) == set(jax_cfg.metric.aggregator.metrics)
    a = port.algo
    assert (a.world_model.stochastic_size, a.world_model.recurrent_model.recurrent_state_size) == (60, 400)
    assert (a.ensembles.n, a.ensembles.optimizer.lr, a.ensembles.optimizer.weight_decay) == (10, 3e-4, 1e-6)
    assert a.player.actor_type == "exploration" and a.intrinsic_reward_multiplier == 10000
    if phase == "finetuning":
        assert a.learning_starts == 16384


@pytest.fixture(scope="module")
def explored(tmp_path_factory):
    root = tmp_path_factory.mktemp("explore")
    s = cli.run(["preset=p2e_dv1_exploration_atari_dummy"] + EXPLORE + [f"log_root={root}", "algo.total_steps=32",
                                                                          "run_name=explore"])
    return root, s


def test_torch_finetune_v1_exploration_run_trains_and_checkpoints(explored):
    root, s = explored
    assert s["policy_steps"] == 32 and s["gradient_steps"] >= 3 and s["player_steps"] > 0
    assert np.isfinite(np.asarray(s["metrics"])).all() and len(s["metric_names"]) == 15
    assert all(row[s["metric_names"].index("Rewards/intrinsic")] > 0 for row in s["metrics"])
    assert all(row[s["metric_names"].index("Params/exploration_amount")] == 0.3 for row in s["metrics"])
    state = load_checkpoint(s["checkpoint"])
    assert set(state) == set(STATE_KEYS) | {"optimizers", "ratio", "iter_num", "batch_size", "last_log",
                                            "last_checkpoint", "train_step", "last_train", "cum", "rng", "rb"}
    assert set(state["optimizers"]) == {"world", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                        "critic_exploration"}
    assert "is_first" not in state["rb"]["envs"][0]["buffer"]
    result = cli.evaluation([f"checkpoint_path={s['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (s["test_reward"], s["test_steps"])


def test_torch_finetune_v1_exploration_resumes(explored):
    root, s = explored
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
                 "algo.learning_starts=2", "algo.total_steps=48", "algo.run_test=false", f"log_root={root}"])
    assert r["start_iter"] == 33 and r["gradient_steps"] > 0 and r["cum_restored"] == s["gradient_steps"]
    assert r["restored_buffer"] == buffer_digest(load_checkpoint(s["checkpoint"])["rb"])


def test_torch_finetune_v1_hands_off(explored, monkeypatch):
    root, s = explored
    explore_state = load_checkpoint(s["checkpoint"])
    seen = {}
    real = p2e_dv1_finetuning.FinetuningLearner.__init__

    def spy(self, cfg, device, state, resumed):
        real(self, cfg, device, state, resumed)
        seen["world_model"] = {k: v.clone() for k, v in self.agent.world_model.state_dict().items()}
        seen["actor_task"] = {k: v.clone() for k, v in self.agent.actor_task.state_dict().items()}
        seen["recurrent"] = cfg.algo.world_model.recurrent_model.recurrent_state_size

    monkeypatch.setattr(p2e_dv1_finetuning.FinetuningLearner, "__init__", spy)
    f = cli.run(["preset=p2e_dv1_finetuning_atari_dummy"] + EXPLORE + [
        f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "buffer.load_from_exploration=true",
        "env.num_envs=2", "algo.world_model.recurrent_model.recurrent_state_size=32", f"log_root={root}",
        "algo.learning_starts=8", "algo.replay_ratio=1", "algo.total_steps=24", "run_name=finetune"])
    assert seen["recurrent"] == 24  # the exploration run's model keys win
    for key in ("world_model", "actor_task"):
        assert all(torch.equal(v, explore_state[key][k]) for k, v in seen[key].items()), key
    assert f["restored_buffer"] == buffer_digest(explore_state["rb"])  # and its 1 env, not the 2 asked for
    assert f["switched_at"] == 8 and f["gradient_steps"] > 0 and f["player_steps"] == 24
    assert np.isfinite(np.asarray(f["metrics"])).all() and len(f["metric_names"]) == 11
    state = load_checkpoint(f["checkpoint"])
    assert set(state) >= {"world_model", "actor_task", "critic_task", "actor_exploration"}
    assert "ensembles" not in state and set(state["optimizers"]) == {"world", "actor", "critic"}
    result = cli.evaluation([f"checkpoint_path={f['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (f["test_reward"], f["test_steps"])
    resumed = cli.run([f"checkpoint.resume_from={f['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
                       f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "algo.learning_starts=2",
                       "algo.total_steps=32", "algo.run_test=false", f"log_root={root}"])
    assert resumed["start_iter"] == 25 and resumed["gradient_steps"] > 0
    assert resumed["restored_buffer"] == buffer_digest(state["rb"])


def test_torch_finetune_v1_rejects_another_env(explored, tmp_path):
    _, s = explored
    with pytest.raises(ValueError, match="environment used during exploration"):
        cli.run(["preset=p2e_dv1_finetuning_atari_dummy"] + EXPLORE + [
            f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "env.id=continuous_dummy", f"log_root={tmp_path}"])


def test_torch_finetune_v1_dry_runs(explored, tmp_path):
    _, s = explored
    dry = ["dry_run=true", "algo.per_rank_sequence_length=1", "algo.replay_ratio=1", "algo.total_steps=100000",
           "algo.learning_starts=5000", f"log_root={tmp_path}"]
    for name, extra in (("exploration", []), ("finetuning", [f"checkpoint.exploration_ckpt_path={s['checkpoint']}"])):
        d = cli.run([f"preset=p2e_dv1_{name}_atari_dummy"] + TINY + dry + extra)
        assert d["policy_steps"] == 1 and d["gradient_steps"] == 1 and d["test_steps"] == 1, name
        assert np.isfinite(np.asarray(d["metrics"])).all()
