"""The port's Pendulum-v1 (``sheeprl_tpu_torch/envs/classic.py``) and its
vector env against what the JAX package's SAC loop steps, on the CPU.

- gymnasium's ``Pendulum-v1`` (``gymnasium.make``, with its 200-step
  ``TimeLimit``): seeded resets and unseeded ones after them, 500 float32
  actions, many outside the [-2, 2] torque bounds, give equal
  observations, rewards (float64, as gymnasium's) and flags, bit for bit,
  through the truncations;
- the vector env against the JAX package's ``FastSyncVectorEnv`` with
  ``SAME_STEP`` autoreset over gymnasium envs: the same observations,
  rewards, flags and ``final_obs``, the final observation of a truncated
  env that SAC stores as its next observation.
"""

import gymnasium as gym
import numpy as np
import pytest

from sheeprl_tpu.envs.vector import FastSyncVectorEnv
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.envs import PendulumEnv, make_vector_env


@pytest.mark.parametrize("seed", [0, 11, 123])
def test_torch_sac_env_pendulum_matches_gymnasium_bit_for_bit(seed):
    ref = gym.make("Pendulum-v1")
    port = PendulumEnv()
    actions = np.random.default_rng(seed).uniform(-3.5, 3.5, size=(500, 1)).astype(np.float32)
    truncations = 0
    for episode_seed in (seed, None, None):
        want, _ = ref.reset(seed=episode_seed)
        got, _ = port.reset(seed=episode_seed)
        np.testing.assert_array_equal(got["state"], want)
        for t in range(200):
            w_obs, w_rew, w_term, w_trunc, _ = ref.step(actions[(t * 7) % 500])
            g_obs, g_rew, g_term, g_trunc, _ = port.step(actions[(t * 7) % 500])
            np.testing.assert_array_equal(g_obs["state"], w_obs, err_msg=f"step {t}")
            assert g_obs["state"].dtype == np.float32
            assert (g_rew, g_term, g_trunc) == (w_rew, w_term, w_trunc), t
            assert type(g_rew) is type(w_rew)
            if w_trunc:
                truncations += 1
                break
    assert truncations == 3 and (np.abs(actions) > 2).mean() > 0.3


def test_torch_sac_env_vector_reports_the_final_observation_like_jax():
    port = make_vector_env(apply_overrides(preset("sac"), ["env.num_envs=3"]), 5)

    def thunk():
        space = gym.spaces.Dict({"state": gym.make("Pendulum-v1").observation_space})
        return lambda: gym.wrappers.TransformObservation(gym.make("Pendulum-v1"), lambda o: {"state": o}, space)

    ref = FastSyncVectorEnv([thunk() for _ in range(3)], autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    np.testing.assert_array_equal(port.reset(seed=5)[0]["state"], ref.reset(seed=5)[0]["state"])
    rng = np.random.default_rng(6)
    ends = 0
    for t in range(420):
        actions = rng.uniform(-2.5, 2.5, size=(3, 1)).astype(np.float32)
        g_obs, g_rew, g_term, g_trunc, g_info = port.step(actions)
        w_obs, w_rew, w_term, w_trunc, w_info = ref.step(actions)
        np.testing.assert_array_equal(g_obs["state"], w_obs["state"], err_msg=f"step {t}")
        np.testing.assert_array_equal(g_rew, w_rew)
        np.testing.assert_array_equal(g_term, w_term)
        np.testing.assert_array_equal(g_trunc, w_trunc)
        for i in np.flatnonzero(w_trunc):
            ends += 1
            np.testing.assert_array_equal(g_info["final_obs"][i]["state"], w_info["final_obs"][i]["state"])
            assert not np.array_equal(g_info["final_obs"][i]["state"], g_obs["state"][i])  # the reset one differs
    port.close()
    ref.close()
    assert ends == 6 and not g_term.any()
    assert port.spaces == {
        "obs": {"state": {"shape": [3], "dtype": "float32"}},
        "actions": {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True},
    }


def test_torch_sac_env_pendulum_needs_one_vector_key():
    with pytest.raises(ValueError, match="mlp_keys"):
        make_vector_env(apply_overrides(preset("sac"), ["algo.mlp_keys.encoder=[]"]), 0)
