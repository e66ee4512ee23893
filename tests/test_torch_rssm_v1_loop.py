"""The Dreamer V1 loop through the port's ``run`` entry point on the CPU at
tiny widths of ``preset=dreamer_v1_atari_dummy`` (its recipe's keys and rows
otherwise):

- the preset is the JAX package's ``exp=dreamer_v1`` on ``env=atari_dummy``,
  full width, for every key both name, bar the buffer cut its ``preset``
  block lists;
- a dry run: one step, one gradient step on a one-row sequence, one test step;
- a run on the per-env sequential buffer (``buffer.type`` does not change
  it, as in JAX): V1's rows (the first observation with a zero action and
  reward, then each observation after its action, no ``is_first``), finite
  metrics with ``Params/exploration_amount`` the recipe's 0.3, a checkpoint
  of the modules, optimizers, ``Ratio``, counters, generator and buffer; a
  resume that starts from exactly the saved buffer and trains; ``evaluation``
  of the checkpoint equal to the run's own greedy test episode;
- V1's lambda-returns (H rows in, H - 1 out) against JAX's within 1e-6;
- the three V1-family trainers are registered, with evaluations and no
  serving; the agents table lists 15 trainers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1.utils import compute_lambda_values as jax_lambda_values
from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DreamerV1Learner
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_sac_loop import _leaves

#: the V1 presets' models cut to a few units (the recipes' keys and rows kept)
TINY = [
    "fabric.accelerator=cpu", "env.num_envs=1", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
    "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.observation_model.cnn_channels_multiplier=2", "algo.world_model.encoder.dense_units=8",
    "algo.world_model.encoder.mlp_layers=1", "algo.world_model.observation_model.dense_units=8",
    "algo.world_model.observation_model.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=24",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.reward_model.dense_units=8", "algo.world_model.reward_model.mlp_layers=1",
    "algo.world_model.discount_model.dense_units=8", "algo.world_model.discount_model.mlp_layers=1",
    "algo.actor.dense_units=8", "algo.actor.mlp_layers=1", "algo.critic.dense_units=8", "algo.critic.mlp_layers=1",
    "algo.world_model.stochastic_size=4", "buffer.size=4096", "metric.log_level=0", "algo.ensembles.n=3",
    "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
]
EXPL = DreamerV1Learner.metric_names.index("Params/exploration_amount")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_torch_rssm_v1_loop_preset_is_the_jax_recipe():
    port = preset("dreamer_v1_atari_dummy")
    assert port.preset.composition == "exp=dreamer_v1 env=atari_dummy"
    jax_cfg = compose(["exp=dreamer_v1", "env=atari_dummy"])
    checked = 0
    for path, value in _leaves(port):
        if path.startswith(("preset.", "metric.aggregator", "buffer.size", "env.id")):
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
    assert (a.per_rank_batch_size, a.per_rank_sequence_length, a.horizon) == (50, 50, 15)
    assert (a.world_model.stochastic_size, a.world_model.recurrent_model.recurrent_state_size) == (30, 200)
    assert (a.dense_units, a.mlp_layers, a.dense_act, a.cnn_act) == (400, 4, "elu", "relu")
    assert (a.world_model.optimizer.lr, a.actor.optimizer.lr, a.critic.optimizer.lr) == (6e-4, 8e-5, 8e-5)
    assert (a.replay_ratio, a.learning_starts, a.actor.expl_amount) == (0.1, 5000, 0.3)


def test_torch_rssm_v1_loop_dry_run(tmp_path):
    summary = cli.run(["preset=dreamer_v1_atari_dummy"] + TINY + [
        "dry_run=true", "algo.per_rank_sequence_length=1", "algo.replay_ratio=1", "algo.total_steps=100000",
        f"log_root={tmp_path}"])
    assert summary["policy_steps"] == 1 and summary["test_steps"] == 1
    assert summary["gradient_steps"] == 1 and np.isfinite(np.asarray(summary["metrics"])).all()


def test_torch_rssm_v1_loop_run_resume_and_evaluation(tmp_path):
    summary = cli.run(["preset=dreamer_v1_atari_dummy"] + TINY + [
        "algo.learning_starts=32", "algo.total_steps=64", "algo.replay_ratio=0.25", "buffer.type=episode",
        "checkpoint.every=0", f"log_root={tmp_path}"])
    assert summary["buffer_type"] == "sequential" and summary["device"] == "cpu"
    G = summary["gradient_steps"]
    assert G >= 6 and len(summary["metrics"]) == G and np.isfinite(np.asarray(summary["metrics"])).all()
    assert summary["metric_names"] == list(DreamerV1Learner.metric_names)
    assert all(row[EXPL] == 0.3 for row in summary["metrics"]) and summary["test_steps"] > 0
    state = load_checkpoint(summary["checkpoint"])
    assert set(state) >= {"world_model", "actor", "critic", "optimizers", "rb", "ratio", "rng", "train_step"}
    assert "target_critic" not in state
    # V1's rows: the first observation with a zero action and reward, then each observation after its action
    rows = {k: v.numpy() for k, v in state["rb"]["envs"][0]["buffer"].items()}
    assert "is_first" not in rows and set(rows) == {"rgb", "actions", "rewards", "terminated", "truncated"}
    assert not rows["actions"][0].any() and rows["rewards"][0, 0] == 0
    assert (np.round(rows["actions"][1:].sum(-1)) == 1).all() and rows["actions"].shape[0] == 65

    result = cli.evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])
    assert (result["reward"], result["steps"]) == (summary["test_reward"], summary["test_steps"])

    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "algo.learning_starts=2",
                       "algo.total_steps=80", "algo.run_test=false", f"log_root={tmp_path}",
                       "fabric.accelerator=cpu", "metric.log_level=0"])
    assert resumed["start_iter"] == 65 and resumed["restored_buffer"] == buffer_digest(state["rb"])
    assert resumed["gradient_steps"] > 0 and resumed["cum_restored"] == G
    assert np.isfinite(np.asarray(resumed["metrics"])).all()


def test_torch_rssm_v1_loop_lambda_values_match_jax():
    rng = np.random.default_rng(6)
    rewards, values, continues = (rng.normal(size=(5, 7, 1)).astype(np.float32) for _ in range(3))
    last = rng.normal(size=(7, 1)).astype(np.float32)
    want = jax_lambda_values(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(continues) * 0.99,
                             jnp.asarray(last), lmbda=0.95)
    got = compute_lambda_values(*(torch.from_numpy(a) for a in (rewards, values, continues * 0.99, last)), lmbda=0.95)
    assert tuple(got.shape) == (4, 7, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_torch_rssm_v1_loop_lambda_values_keep_the_gradient():
    values = torch.randn(4, 2, 1, requires_grad=True)
    out = compute_lambda_values(torch.randn(4, 2, 1), values, torch.full((4, 2, 1), 0.99), values[-1])
    (grad,) = torch.autograd.grad(out.sum(), values)
    assert grad[0].abs().sum() == 0 and (grad[1:].abs() > 0).all()  # the first value enters no return


def test_torch_rssm_v1_loop_is_registered():
    rows = {r["name"]: r for r in cli.agents()}
    for name in ("dreamer_v1", "p2e_dv1_exploration", "p2e_dv1_finetuning"):
        assert rows[name]["trainer"] and rows[name]["evaluation"] and not rows[name]["serving"]
    # every trainer of the JAX package: the Dreamer and P2E families, PPO, SAC, Anakin and the async ones
    assert sum(1 for r in rows.values() if r["trainer"]) == 22
