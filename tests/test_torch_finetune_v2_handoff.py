"""Plan2Explore on Dreamer V2 through the port's entry points on the CPU, at
tiny widths of ``preset=p2e_dv2_exploration_atari_dummy`` and
``preset=p2e_dv2_finetuning_atari_dummy``:

- the four V2-family presets are the JAX package's recipes
  (``exp=dreamer_v2``, ``exp=dreamer_v2_ms_pacman``, ``exp=p2e_dv2_*``) on
  ``env=atari_dummy``, full width, for every key both name, bar the cuts and
  stand-ins their ``preset`` blocks list;
- an exploration run trains every module (T + 2H plain GRU calls a gradient
  step), checkpoints every module, optimizer and the buffer, and resumes;
- ``run preset=p2e_dv2_finetuning_atari_dummy
  checkpoint.exploration_ckpt_path=<ckpt> buffer.load_from_exploration=true``
  starts from it: another env id raises; the exploration run's model keys
  win; the exploration's buffer and ``num_envs`` are taken; the player acts
  with the exploration actor until the first granted gradient step and then
  with the task actor; the world model and task actor start as the
  exploration left them; Dreamer V2's T + H GRU calls a step;
- ``evaluation`` of either checkpoint is the run's own greedy test episode
  of the task actor.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning
from sheeprl_tpu_torch.algos.p2e_dv2.agent import STATE_KEYS
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_rssm_v2_loop import TINY, GruCount
from tests.test_torch_sac_loop import _leaves

T, H = 8, 3
EXPLORE = TINY + ["algo.learning_starts=16", "algo.replay_ratio=0.25", "algo.per_rank_pretrain_steps=0",
                  "buffer.memmap=false", "checkpoint.every=0", "checkpoint.save_last=true"]
#: what the presets set otherwise than the JAX recipe, on purpose (their ``preset`` blocks)
RECIPES = {
    "dreamer_v2_atari_dummy": "exp=dreamer_v2",
    "dreamer_v2_ms_pacman_dummy": "exp=dreamer_v2_ms_pacman",
    "p2e_dv2_exploration_atari_dummy": "exp=p2e_dv2_exploration",
    "p2e_dv2_finetuning_atari_dummy": "exp=p2e_dv2_finetuning",
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(RECIPES), ids=lambda n: n.replace("dreamer_v2", "dv2").replace("p2e_", "x_"))
def test_torch_finetune_v2_presets_are_the_jax_recipes(name):
    port = preset(name)
    exp = RECIPES[name]
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
    assert port.buffer.size == 100000 and jax_cfg.buffer.size in (5000000, 2000000)
    assert any("buffer.size" in r for r in port.preset.reduced)
    assert set(port.metric.aggregator.metrics) == set(jax_cfg.metric.aggregator.metrics)


def test_torch_finetune_v2_preset_widths():
    v2, pacman = preset("dreamer_v2_atari_dummy").algo, preset("dreamer_v2_ms_pacman_dummy")
    assert v2.world_model.recurrent_model.recurrent_state_size == 600 and v2.dense_units == 400
    assert v2.world_model.encoder.cnn_channels_multiplier == 48 and v2.mlp_layers == 4
    assert (v2.per_rank_batch_size, v2.per_rank_sequence_length, v2.horizon) == (16, 50, 15)
    assert v2.world_model.optimizer.weight_decay == 1e-6 and v2.actor.optimizer.eps == 1e-5
    assert pacman.buffer.type == "episode" and pacman.buffer.prioritize_ends and pacman.algo.gamma == 0.995
    assert pacman.algo.world_model.use_continues and pacman.algo.per_rank_batch_size == 32
    p2e = preset("p2e_dv2_exploration_atari_dummy").algo
    assert p2e.world_model.recurrent_model.recurrent_state_size == 400 and p2e.ensembles.n == 10


@pytest.fixture(scope="module")
def explored(tmp_path_factory):
    root = tmp_path_factory.mktemp("explore")
    mp = pytest.MonkeyPatch()
    count = GruCount(mp)
    s = cli.run(["preset=p2e_dv2_exploration_atari_dummy"] + EXPLORE + [f"log_root={root}", "algo.total_steps=32",
                                                                          "run_name=explore"])
    mp.undo()
    return root, s, count.n


def test_torch_finetune_v2_exploration_run_trains_and_checkpoints(explored):
    root, s, calls = explored
    assert s["policy_steps"] == 32 and s["gradient_steps"] >= 3 and s["player_steps"] > 0
    assert np.isfinite(np.asarray(s["metrics"])).all() and len(s["metric_names"]) == 14
    assert all(row[s["metric_names"].index("Rewards/intrinsic")] > 0 for row in s["metrics"])
    assert calls == s["gradient_steps"] * (T + 2 * H) + s["player_steps"] + s["test_steps"]
    state = load_checkpoint(s["checkpoint"])
    assert set(state) == set(STATE_KEYS) | {"optimizers", "ratio", "iter_num", "batch_size", "last_log",
                                            "last_checkpoint", "train_step", "last_train", "cum", "rng", "rb"}
    assert set(state["optimizers"]) == {"world", "ensembles", "actor_task", "critic_task", "actor_exploration",
                                        "critic_exploration"}
    result = cli.evaluation([f"checkpoint_path={s['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (s["test_reward"], s["test_steps"])


def test_torch_finetune_v2_exploration_resumes(explored):
    root, s, _ = explored
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
                 "algo.learning_starts=2", "algo.total_steps=48", "algo.run_test=false", f"log_root={root}"])
    assert r["start_iter"] == 33 and r["gradient_steps"] > 0 and r["cum_restored"] == s["gradient_steps"]
    assert r["restored_buffer"] == buffer_digest(load_checkpoint(s["checkpoint"])["rb"])


def test_torch_finetune_v2_hands_off(explored, monkeypatch):
    root, s, _ = explored
    explore_state = load_checkpoint(s["checkpoint"])
    seen = {}
    real = p2e_dv2_finetuning.FinetuningLearner.__init__

    def spy(self, cfg, device, state, resumed):
        real(self, cfg, device, state, resumed)
        seen["world_model"] = {k: v.clone() for k, v in self.agent.world_model.state_dict().items()}
        seen["actor_task"] = {k: v.clone() for k, v in self.agent.actor_task.state_dict().items()}
        seen["recurrent"] = cfg.algo.world_model.recurrent_model.recurrent_state_size

    monkeypatch.setattr(p2e_dv2_finetuning.FinetuningLearner, "__init__", spy)
    count = GruCount(monkeypatch)
    f = cli.run(["preset=p2e_dv2_finetuning_atari_dummy"] + EXPLORE + [
        f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "buffer.load_from_exploration=true",
        "env.num_envs=2", "algo.world_model.recurrent_model.recurrent_state_size=32", f"log_root={root}",
        "algo.learning_starts=8", "algo.replay_ratio=1", "algo.total_steps=24", "run_name=finetune"])
    assert seen["recurrent"] == 24  # the exploration run's model keys win
    for key in ("world_model", "actor_task"):
        assert all(torch.equal(v, explore_state[key][k]) for k, v in seen[key].items()), key
    assert f["restored_buffer"] == buffer_digest(explore_state["rb"])  # and its 1 env, not the 2 asked for
    assert f["switched_at"] == 8 and f["gradient_steps"] > 0 and f["player_steps"] == 24
    assert count.n == f["gradient_steps"] * (T + H) + f["player_steps"] + f["test_steps"]
    state = load_checkpoint(f["checkpoint"])
    assert set(state) >= {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration"}
    assert "ensembles" not in state
    result = cli.evaluation([f"checkpoint_path={f['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (f["test_reward"], f["test_steps"])


def test_torch_finetune_v2_rejects_another_env(explored, tmp_path):
    _, s, _ = explored
    with pytest.raises(ValueError, match="environment used during exploration"):
        cli.run(["preset=p2e_dv2_finetuning_atari_dummy"] + EXPLORE + [
            f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "env.id=continuous_dummy", f"log_root={tmp_path}"])
    with pytest.raises(ValueError, match="p2e_dv2_finetuning needs checkpoint.exploration_ckpt_path"):
        cli.run(["preset=p2e_dv2_finetuning_atari_dummy"] + EXPLORE + [f"log_root={tmp_path}"])


def test_torch_finetune_v2_dry_runs(explored, tmp_path, monkeypatch):
    """``dry_run=true`` of both P2E-DV2 presets: one iteration on the 4-row
    dry-run buffer, its gradient step's T + 2H (exploration) or T + H
    (finetuning, from the exploration's checkpoint) GRU calls at sequence
    length 1, and the one-step test episode."""
    _, s, _ = explored
    dry = ["dry_run=true", "algo.per_rank_sequence_length=1", "algo.replay_ratio=1", "algo.total_steps=100000",
           "algo.learning_starts=5000", f"log_root={tmp_path}"]
    for name, per_step, extra in (("exploration", 1 + 2 * H, []),
                                  ("finetuning", 1 + H, [f"checkpoint.exploration_ckpt_path={s['checkpoint']}"])):
        count = GruCount(monkeypatch)
        d = cli.run([f"preset=p2e_dv2_{name}_atari_dummy"] + TINY + dry + extra)
        assert d["policy_steps"] == 1 and d["gradient_steps"] == 1 and d["test_steps"] == 1, name
        assert np.isfinite(np.asarray(d["metrics"])).all()
        assert count.n == per_step + d["player_steps"] + d["test_steps"], name
