"""The port's CartPole-v1 (``sheeprl_tpu_torch/envs/classic.py``), its vector
env and its rollout buffer against what the JAX package's PPO loop uses, on
the CPU.

- gymnasium's ``CartPole-v1`` (``gymnasium.make``, with its 500-step
  ``TimeLimit``): one seed and a fixed 600-action sequence give equal
  observations, rewards and flags, bit for bit, through termination, the
  truncation at 500 steps and the resets after each;
- the pure-JAX twin ``sheeprl_tpu/envs/jax_envs/cartpole.py`` steps in
  float32 where gymnasium keeps float64: stepped from the twin's state each
  step, the port's observation within atol 1e-5 of it over 500 steps;
- the vector env against the JAX package's ``FastSyncVectorEnv`` with
  ``SAME_STEP`` autoreset over gymnasium envs: the same observations,
  rewards, flags and ``final_obs``;
- ``ReplayBuffer.add``/``to_numpy`` against the JAX buffer's, exactly.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.envs.jax_envs.cartpole import CartPoleState, JaxCartPole
from sheeprl_tpu.envs.vector import FastSyncVectorEnv
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import CartPoleEnv, make_vector_env


def _actions(seed, n):
    """A policy that holds the pole up for a while, then random pushes: the
    sequence runs episodes to termination and one to the 500-step limit."""
    return np.random.default_rng(seed).integers(0, 2, size=n)


def _balancing(obs):
    return int(obs[2] + 0.5 * obs[3] > 0)


def test_torch_ppo_env_cartpole_matches_gymnasium_bit_for_bit():
    ref = gym.make("CartPole-v1")
    port = CartPoleEnv()
    want, _ = ref.reset(seed=11)
    got, _ = port.reset(seed=11)
    np.testing.assert_array_equal(got["state"], want)
    assert got["state"].dtype == np.float32
    random_actions = _actions(0, 600)
    ends = {"terminated": 0, "truncated": 0}
    balanced = 0
    for t in range(1200):
        # balance until one episode has hit the time limit, then follow the fixed sequence
        a = _balancing(want) if ends["truncated"] == 0 else int(random_actions[t % 600])
        balanced += ends["truncated"] == 0
        w_obs, w_rew, w_term, w_trunc, _ = ref.step(a)
        g_obs, g_rew, g_term, g_trunc, _ = port.step(a)
        np.testing.assert_array_equal(g_obs["state"], w_obs, err_msg=f"step {t}")
        assert (g_rew, g_term, g_trunc) == (w_rew, w_term, w_trunc), t
        want = w_obs
        if w_term or w_trunc:
            ends["terminated"] += bool(w_term)
            ends["truncated"] += bool(w_trunc and not w_term)
            want, _ = ref.reset()
            got, _ = port.reset()
            np.testing.assert_array_equal(got["state"], want)
    assert ends["truncated"] >= 1 and ends["terminated"] >= 3 and balanced >= 500


def test_torch_ppo_env_cartpole_matches_the_jax_twin_within_float32():
    """The twin's step from the same state: the port's state is set to the
    twin's float32 one before every step, so the float32/float64 gap does not
    compound (as the JAX package's own tight twin test does)."""
    twin = JaxCartPole()
    port = CartPoleEnv()
    obs = port.reset(seed=3)[0]["state"]
    state = CartPoleState(physics=jnp.asarray(obs), t=jnp.zeros((), jnp.int32))
    step = jax.jit(twin.step)
    rng = np.random.default_rng(5)
    episodes = 0
    for t in range(500):
        a = int(rng.integers(2))
        port.state = np.asarray(state.physics, dtype=np.float64)
        state, j_obs, j_rew, j_done, info = step(state, jnp.int32(a))
        g, reward, term, _, _ = port.step(a)
        np.testing.assert_allclose(g["state"], np.asarray(j_obs), atol=1e-5, rtol=1e-5, err_msg=f"step {t}")
        assert reward == float(j_rew) and term == bool(info["terminated"]), t
        if term:
            episodes += 1
            obs = port.reset()[0]["state"]
            state = CartPoleState(physics=jnp.asarray(obs), t=jnp.zeros((), jnp.int32))
    assert episodes >= 5


def test_torch_ppo_env_vector_autoresets_like_jax():
    limit_cfg = apply_overrides(preset("ppo"), ["env.num_envs=3"])
    port = make_vector_env(limit_cfg, 21)

    def thunk():
        return lambda: gym.wrappers.TransformObservation(
            gym.make("CartPole-v1"), lambda o: {"state": o}, gym.spaces.Dict({"state": gym.make("CartPole-v1").observation_space})
        )

    ref = FastSyncVectorEnv([thunk() for _ in range(3)], autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    np.testing.assert_array_equal(port.reset(seed=21)[0]["state"], ref.reset(seed=21)[0]["state"])
    rng = np.random.default_rng(4)
    ends = 0
    for t in range(300):
        actions = rng.integers(0, 2, size=3)
        g_obs, g_rew, g_term, g_trunc, g_info = port.step(actions)
        w_obs, w_rew, w_term, w_trunc, w_info = ref.step(actions)
        np.testing.assert_array_equal(g_obs["state"], w_obs["state"], err_msg=f"step {t}")
        np.testing.assert_array_equal(g_rew, w_rew)
        np.testing.assert_array_equal(g_term, w_term)
        np.testing.assert_array_equal(g_trunc, w_trunc)
        for i in np.flatnonzero(np.logical_or(w_term, w_trunc)):
            ends += 1
            np.testing.assert_array_equal(g_info["final_obs"][i]["state"], w_info["final_obs"][i]["state"])
        assert [e[0] for e in g_info.get("episodes", ())] == list(np.flatnonzero(np.logical_or(w_term, w_trunc)))
    port.close()
    ref.close()
    assert ends >= 10
    assert port.spaces == {"obs": {"state": {"shape": [4], "dtype": "float32"}}, "actions": {"n": [2], "continuous": False}}


def test_torch_ppo_env_rejects_pixel_keys_on_cartpole():
    # an override list of bare words parses as a list, as the JAX package's CLI reads it
    assert apply_overrides({}, ["a=[rgb, state]", "b=[]"]) == {"a": ["rgb", "state"], "b": []}
    with pytest.raises(ValueError, match="mlp_keys"):
        make_vector_env(apply_overrides(preset("ppo"), ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]"]), 0)
    with pytest.raises(NotImplementedError, match="not ported"):
        make_vector_env(apply_overrides(preset("ppo"), ["env.id=LunarLanderContinuous-v3"]), 0)


@pytest.mark.parametrize("size, steps", [(16, 16), (16, 23), (8, 3)], ids=["one-lap", "wraps", "partial"])
def test_torch_ppo_env_rollout_buffer_matches_jax(size, steps):
    port, ref = ReplayBuffer(size, 3, ("state",)), JaxReplayBuffer(size, 3, obs_keys=("state",))
    rng = np.random.default_rng(size + steps)
    for _ in range(steps):
        row = {
            "state": rng.normal(size=(1, 3, 4)).astype(np.float32),
            "rewards": rng.normal(size=(1, 3, 1)),  # float64, handed out as float32
            "dones": (rng.uniform(size=(1, 3, 1)) < 0.2).astype(np.uint8),
        }
        port.add(row)
        ref.add(row)
    got, want = port.to_numpy(), ref.to_numpy()
    assert set(got) == set(want)
    written = min(steps, size)  # rows past the head of a partial buffer are uninitialised on both sides
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape == (size, 3, *want[k].shape[2:])
        np.testing.assert_array_equal(got[k][:written], want[k][:written])
    assert got["rewards"].dtype == np.float32
