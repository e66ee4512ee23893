"""The port's recurrent PPO loop through ``cli.run`` on the CPU
(``fabric.accelerator=cpu``), at small widths of the JAX recipe:

- a run trains with the plain GAE (the CUDA kernel's launch count stays 0),
  its padded sequence counts are ``bucket``'s, a checkpoint resumes with its
  counters going on, and ``evaluation`` repeats the run's test episode;
- the stored rollout is the JAX loop's: each step's ``prev_actions`` are
  the previous step's actions zeroed where an episode ended, and its
  ``prev_hx``/``prev_cx`` the pair it started from, zero after an episode's
  end;
- the bootstrap values use the unmasked last actions: GAE's bootstrap is
  fed the last step's actions (not the done-masked ``prev_actions``) with
  the reset pair, and a truncation's ``r += gamma * V(final obs)`` the
  step's own actions with its pre-reset pair;
- the continuous and multi-discrete counter envs run, as the JAX suite
  runs them.
"""

import importlib

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as agent_module
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import bucket
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

loop = importlib.import_module("sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent")

SMALL = ["preset=ppo_recurrent", "fabric.accelerator=cpu", "metric.log_level=0", "env.num_envs=2",
         "algo.rollout_steps=32", "algo.per_rank_sequence_length=8", "algo.per_rank_num_batches=2",
         "algo.update_epochs=1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_ppo_recurrent_loop_trains_checkpoints_and_resumes(tmp_path):
    K.reset_launches()
    first = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=192"])
    assert first["device"] == "cpu" and first["iterations"] == 3 and first["policy_steps"] == 192
    assert np.isfinite(np.asarray(first["losses"])).all() and K.LAUNCHES["gae"] == 0
    assert all(s == bucket(s, 2) and s >= 8 for s in first["sequences"])
    state = load_checkpoint(first["checkpoint"])
    assert {"agent", "optimizer", "iter_num", "batch_size", "last_log", "last_checkpoint", "rng"} <= set(state)
    assert state["iter_num"] == 3 and not state["agent"]["rnn.lstm.bias_ih_l0"].any()
    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", f"log_root={tmp_path}", "algo.total_steps=256"])
    assert resumed["start_iter"] == 4 and resumed["iterations"] == 1 and resumed["policy_steps"] == 256
    evaluated = cli.evaluation([f"checkpoint_path={resumed['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["reward"] == resumed["test_reward"] and evaluated["steps"] == resumed["test_steps"]


def _recording(monkeypatch):
    """Record every rollout handed to the update and every value call."""
    rollouts, value_calls = [], []
    prepare = loop.prepare_update

    def keep(local, returns, advantages, *args):
        rollouts.append({k: np.array(v) for k, v in local.items()})
        return prepare(local, returns, advantages, *args)

    get_values = agent_module.RecurrentPPOPlayer.get_values

    def values(self, obs, prev_actions, states):
        out = get_values(self, obs, prev_actions, states)
        value_calls.append({"obs": {k: v.clone() for k, v in obs.items()}, "actions": prev_actions.clone(),
                            "hx": states[0].clone(), "cx": states[1].clone(), "values": out[0].clone()})
        return out

    monkeypatch.setattr(loop, "prepare_update", keep)
    monkeypatch.setattr(agent_module.RecurrentPPOPlayer, "get_values", values)
    return rollouts, value_calls


def test_torch_ppo_recurrent_loop_stores_jax_s_rollout_and_bootstraps_on_unmasked_actions(tmp_path, monkeypatch):
    rollouts, value_calls = _recording(monkeypatch)
    # the discrete counter env ends an episode every 5 steps: the 10-step rollout's last step is a done
    cli.run(SMALL + ["env.id=discrete_dummy", "algo.rollout_steps=10", "algo.total_steps=40",
                     f"log_root={tmp_path}", "algo.run_test=false"])
    assert len(rollouts) == len(value_calls) == 2
    for local, call in zip(rollouts, value_calls):
        dones = local["dones"]
        assert dones[4].all() and dones[9].all() and dones.sum() == 2 * 2
        keep = 1.0 - dones[:-1]
        np.testing.assert_array_equal(local["prev_actions"][1:], keep * local["actions"][:-1])
        assert not local["prev_actions"][5].any() and local["prev_actions"][6].any()
        # the pair resets after the done at step 4 (it had moved by then); the counter env's reset
        # observation is all zeros, so with no previous action step 5 leaves it at zero, and step 6 moves it
        assert local["prev_hx"][4].any() and not local["prev_hx"][5].any() and not local["prev_cx"][5].any()
        assert local["prev_hx"][7].any() and local["prev_cx"][7].any()
        # the bootstrap: the last actions as they were, not masked by the done, and the reset pair
        np.testing.assert_array_equal(call["actions"].numpy()[0], local["actions"][-1])
        assert call["actions"].any() and not call["hx"].any() and not call["cx"].any()
    # each rollout starts after a done: no previous action
    assert not rollouts[0]["prev_actions"][0].any() and not rollouts[1]["prev_actions"][0].any()


def test_torch_ppo_recurrent_loop_truncation_bootstrap(tmp_path, monkeypatch):
    rollouts, value_calls = _recording(monkeypatch)
    cli.run(SMALL + ["env.max_episode_steps=7", "algo.total_steps=64", f"log_root={tmp_path}", "algo.run_test=false"])
    (local,) = rollouts
    truncations = value_calls[:-1]  # the last call is GAE's bootstrap
    assert len(truncations) >= 4
    rewards, dones = local["rewards"].reshape(-1), local["dones"].reshape(-1)
    bootstrapped = rewards != 1.0
    assert dones[bootstrapped].all() and bootstrapped.sum() == sum(c["values"].numel() for c in truncations)
    want = np.concatenate([(1.0 + np.float32(0.99) * c["values"].numpy().reshape(-1)) for c in truncations])
    np.testing.assert_allclose(rewards[bootstrapped], want.astype(np.float32), rtol=1e-6)
    for c in truncations:  # the step's own actions and its pre-reset pair
        assert c["actions"].any() and c["hx"].any() and c["cx"].any()


@pytest.mark.parametrize("env_id", ["continuous_dummy", "multidiscrete_dummy"])
def test_torch_ppo_recurrent_loop_runs_the_counter_envs(tmp_path, env_id):
    out = cli.run(SMALL + [f"env.id={env_id}", "algo.rollout_steps=8", "algo.per_rank_sequence_length=4",
                           "algo.total_steps=32", f"log_root={tmp_path}"])
    assert out["iterations"] == 2 and np.isfinite(np.asarray(out["losses"])).all()
    assert out["test_steps"] == 129  # both counter envs end on the step after their 128th
