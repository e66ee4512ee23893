"""The Dreamer V2 loop through the port's ``run`` entry point on the CPU at
tiny widths (its presets' recipes otherwise): each preset's dry run; a run
on the sequential buffer and one on the episode buffer (``prioritize_ends``
and the continue head, ``preset=dreamer_v2_ms_pacman_dummy``), each with a
checkpoint, a resume that starts from exactly the saved buffer (rows, heads,
generators) and the saved gradient-step count, and whose first target copy
falls on its first gradient step, as the JAX loop's does (it counts from 0);
the plain GRU cell run exactly ``G (T + H)`` times in training, once per
player step and once per test-episode step (the card's ``gru_gates_ln``
launches); ``evaluation`` of a checkpoint equal to the run's own greedy test
episode; a ``buffer.type`` other than ``sequential`` or ``episode`` raises,
as does resuming a checkpoint's buffer of the other type."""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest
from sheeprl_tpu_torch.data import EpisodeBuffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

#: the presets' models cut to a few units (the recipes' keys and rows kept)
TINY = [
    "fabric.accelerator=cpu", "env.num_envs=1", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
    "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.observation_model.cnn_channels_multiplier=2", "algo.world_model.encoder.dense_units=8",
    "algo.world_model.encoder.mlp_layers=1", "algo.world_model.observation_model.dense_units=8",
    "algo.world_model.observation_model.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=24",
    "algo.world_model.recurrent_model.dense_units=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.reward_model.dense_units=8",
    "algo.world_model.reward_model.mlp_layers=1", "algo.world_model.discount_model.dense_units=8",
    "algo.world_model.discount_model.mlp_layers=1", "algo.actor.dense_units=8", "algo.actor.mlp_layers=1",
    "algo.critic.dense_units=8", "algo.critic.mlp_layers=1", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "buffer.size=4096", "metric.log_level=0", "algo.ensembles.n=3",
    "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
]
T, H = 8, 3


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class GruCount:
    """Counts the plain GRU cell's calls (where the card launches
    ``gru_gates_ln``)."""

    def __init__(self, monkeypatch):
        from sheeprl_tpu_torch.ops.kernels import gru

        self.n = 0
        plain = gru.gru_gates_ln_reference

        def counted(*args):
            self.n += 1
            return plain(*args)

        monkeypatch.setattr(gru, "gru_gates_ln_reference", counted)


def _want(summary, per_step):
    return summary["gradient_steps"] * per_step + summary["player_steps"] + (summary["test_steps"] or 0)


@pytest.fixture
def copies(monkeypatch):
    """The ``cum`` of every gradient step, and those where the targets were copied."""
    seen = {"cum": [], "copied": []}
    real = dreamer_v2.hard_copy

    def recorded(pairs, cum, freq):
        seen["cum"].append(cum)
        if cum % freq == 0:
            seen["copied"].append(cum)
        real(pairs, cum, freq)

    monkeypatch.setattr(dreamer_v2, "hard_copy", recorded)
    return seen


@pytest.mark.parametrize("preset", ["dreamer_v2_atari_dummy", "dreamer_v2_ms_pacman_dummy"],
                         ids=["sequential", "episode"])
def test_torch_rssm_v2_loop_dry_run(tmp_path, monkeypatch, preset):
    count = GruCount(monkeypatch)
    summary = cli.run([f"preset={preset}"] + TINY + [
        "dry_run=true", "algo.per_rank_sequence_length=1", "algo.per_rank_pretrain_steps=0", "algo.replay_ratio=1",
        "algo.total_steps=100000", f"log_root={tmp_path}"])
    assert summary["policy_steps"] == 1 and summary["test_steps"] == 1  # a dry run's test episode is one step
    assert summary["gradient_steps"] == 1 and np.isfinite(np.asarray(summary["metrics"])).all()
    assert count.n == _want(summary, 1 + H)


def test_torch_rssm_v2_loop_sequential_run_resume_and_evaluation(tmp_path, monkeypatch, copies):
    count = GruCount(monkeypatch)
    summary = cli.run(["preset=dreamer_v2_atari_dummy"] + TINY + [
        "algo.learning_starts=64", "algo.total_steps=96", "algo.per_rank_pretrain_steps=20", "checkpoint.every=0",
        f"log_root={tmp_path}"])
    assert summary["buffer_type"] == "sequential" and summary["device"] == "cpu"
    G = summary["gradient_steps"]
    assert G >= 6 and len(summary["metrics"]) == G and np.isfinite(np.asarray(summary["metrics"])).all()
    assert count.n == _want(summary, T + H) and summary["test_steps"] > 0
    assert copies["cum"] == list(range(G)) and copies["copied"] == [0]  # freq 100: the first step copies
    state = load_checkpoint(summary["checkpoint"])
    assert state["cum"] == G and set(state) >= {"world_model", "actor", "critic", "target_critic", "optimizers", "rb"}
    assert isinstance(state["optimizers"]["world"]["param_groups"][0]["weight_decay"], float)

    result = cli.evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (summary["test_reward"], summary["test_steps"])

    copies["cum"].clear(), copies["copied"].clear()
    count.n = 0
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "algo.learning_starts=2",
                       "algo.total_steps=112", "algo.run_test=false", f"log_root={tmp_path}",
                       "fabric.accelerator=cpu", "metric.log_level=0"])
    assert resumed["start_iter"] == 97 and resumed["cum_restored"] == G and resumed["cum"] == G + resumed["gradient_steps"]
    assert resumed["restored_buffer"] == buffer_digest(state["rb"])
    assert resumed["gradient_steps"] > 0 and copies["copied"] == [0] and copies["cum"][0] == 0  # JAX's count from 0
    assert count.n == _want(resumed, T + H)


def test_torch_rssm_v2_loop_episode_run_and_resume(tmp_path, monkeypatch):
    """The episode buffer fills at the dummy env's first episode end (366
    steps for seed 5); training waits for it."""
    count = GruCount(monkeypatch)
    live = {}  # the buffer's own state at the save, beside the patched copy the checkpoint holds
    patched = EpisodeBuffer.checkpoint_state_dict
    monkeypatch.setattr(EpisodeBuffer, "checkpoint_state_dict",
                        lambda self: live.setdefault("state", self.state_dict()) and patched(self))
    summary = cli.run(["preset=dreamer_v2_ms_pacman_dummy"] + TINY + [
        "algo.learning_starts=368", "algo.total_steps=420", "algo.run_test=false", "checkpoint.every=0",
        f"log_root={tmp_path}"])
    assert summary["buffer_type"] == "episode"
    G = summary["gradient_steps"]
    assert G >= 3 and np.isfinite(np.asarray(summary["metrics"])).all()
    assert all(row[dreamer_v2.METRIC_NAMES.index("Loss/continue_loss")] > 0 for row in summary["metrics"])
    assert count.n == _want(summary, T + H)
    state = load_checkpoint(summary["checkpoint"])
    # the first episode: its first observation's row and one row per env step
    assert state["rb"]["cum_lengths"][0] == 367 and len(state["rb"]["open"]) == 1
    # the JAX loop's rows: the first observation with is_first and a zero action and
    # reward, then each observation after its action; the episode's last row ends it
    ep = {k: v.numpy() for k, v in state["rb"]["episodes"][0].items()}
    assert ep["is_first"][0, 0] == 1 and not ep["is_first"][1:].any()
    assert not ep["actions"][0].any() and (ep["actions"][1:].sum(-1) == 1).all() and ep["rewards"][0, 0] == 0
    done = np.logical_or(ep["terminated"], ep["truncated"])[:, 0]
    assert done[-1] and not done[:-1].any()
    # the checkpoint drops the open episode, as JAX's CheckpointCallback saves the buffer;
    # the live buffer's next episode starts on the reset observation, with is_first and no action
    assert state["rb"]["open"] == [[]] and len(live["state"]["open"][0]) > 0
    first_open = live["state"]["open"][0][0]
    assert first_open["is_first"][0, 0] == 1 and not first_open["actions"][0].any()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "algo.learning_starts=2",
                       "algo.total_steps=452", "algo.run_test=false", f"log_root={tmp_path}",
                       "fabric.accelerator=cpu"])
    assert resumed["restored_buffer"] == buffer_digest(state["rb"]) and resumed["buffer_type"] == "episode"
    assert resumed["gradient_steps"] > 0 and resumed["cum_restored"] == G
    with pytest.raises(RuntimeError, match="episode"):
        cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "buffer.type=sequential",
                 f"log_root={tmp_path}", "fabric.accelerator=cpu", "algo.total_steps=424"])


def test_torch_rssm_v2_loop_rejects_an_unknown_buffer_type(tmp_path):
    with pytest.raises(ValueError, match="Unrecognized buffer type"):
        cli.run(["preset=dreamer_v2_atari_dummy"] + TINY + ["buffer.type=prioritized", "algo.total_steps=2",
                                                             f"log_root={tmp_path}"])


def test_torch_rssm_v2_loop_is_registered():
    rows = {r["name"]: r for r in cli.agents()}
    for name in ("dreamer_v2", "p2e_dv2_exploration", "p2e_dv2_finetuning"):
        assert rows[name]["trainer"] and rows[name]["evaluation"] and not rows[name]["serving"]


def test_torch_rssm_v2_loop_exploration_noise(tmp_path):
    """``algo.actor.expl_amount`` (the JAX player's epsilon exploration; 0 in
    every recipe): amount 0 leaves the actions as they are; a continuous
    action gets Gaussian jitter clipped to [-1, 1]; each discrete head is
    resampled uniformly, one-hot, for about ``expl_amount`` of the rows; a
    run with it plays and trains."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import add_exploration_noise

    gen = torch.Generator().manual_seed(0)
    acts = [torch.nn.functional.one_hot(torch.zeros(4000, dtype=torch.int64), 5).float()]
    assert add_exploration_noise(acts, 0.0, False, gen)[0] is acts[0]
    noisy = add_exploration_noise(acts, 0.3, False, gen)[0]
    assert torch.equal(noisy.sum(-1), torch.ones(4000)) and set(noisy.unique().tolist()) == {0.0, 1.0}
    changed = float((noisy.argmax(-1) != 0).float().mean())
    assert 0.2 < changed < 0.28  # 0.3 resampled, 4 in 5 of those to another action
    cont = add_exploration_noise([torch.full((1000, 2), 0.95)], 0.5, True, gen)[0]
    assert cont.max() <= 1.0 and cont.min() >= -1.0 and float(cont.std()) > 0.2
    summary = cli.run(["preset=dreamer_v2_atari_dummy"] + TINY + [
        "algo.actor.expl_amount=0.3", "algo.learning_starts=16", "algo.total_steps=32", "algo.replay_ratio=0.25",
        "algo.run_test=false", f"log_root={tmp_path}"])
    assert summary["player_steps"] == 16 and summary["gradient_steps"] > 0
    assert np.isfinite(np.asarray(summary["metrics"])).all()
