"""The port's step-counter dummy envs (``sheeprl_tpu_torch/envs/dummy.py``,
ids ``continuous_dummy``, ``discrete_dummy``, ``multidiscrete_dummy``)
against the JAX package's (``sheeprl_tpu/envs/dummy.py`` through its
factory's ``make_env`` with ``env=dummy``), step by step on the CPU: every
observation key, reward, termination and truncation equal, exactly, over
three episodes; and the spaces block equal to the gymnasium spaces the JAX
envs declare. Through the vector env, an episode ends every ``n_steps + 1``
steps with a reset observation of counter 0."""

import numpy as np
import pytest

from sheeprl_tpu.config import compose
from sheeprl_tpu.envs.factory import make_env as jax_make_env
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.envs import COUNTER_ENVS, make_env, make_vector_env

IDS = ["continuous_dummy", "discrete_dummy", "multidiscrete_dummy"]
KEYS = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"]


def _pair(env_id):
    jax_cfg = compose(["exp=ppo", "env=dummy", f"env.id={env_id}", "env.capture_video=False"] + KEYS)
    port_cfg = apply_overrides(preset("ppo"), [f"env.id={env_id}"] + KEYS)
    return jax_make_env(jax_cfg, 3, 0)(), make_env(port_cfg, 3)


def _action(space, rng):
    if "n" in space:
        return np.asarray([rng.integers(0, n) for n in space["n"]]) if len(space["n"]) > 1 else rng.integers(0, space["n"][0])
    return rng.uniform(-1, 1, size=space["shape"]).astype(np.float32)


@pytest.mark.parametrize("env_id", IDS)
def test_torch_counter_envs_step_like_jax_s(env_id):
    jax_env, port_env = _pair(env_id)
    rng = np.random.default_rng(0)
    j_obs, _ = jax_env.reset(seed=3)
    p_obs, _ = port_env.reset(seed=3)
    ends = 0
    for _ in range(3 * (port_env._n_steps + 1)):
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(p_obs[k], j_obs[k], err_msg=k)
            assert p_obs[k].dtype == j_obs[k].dtype and p_obs[k].shape == j_obs[k].shape
        a = _action(port_env.spaces["actions"], rng)
        j_obs, j_r, j_term, j_trunc, _ = jax_env.step(a)
        p_obs, p_r, p_term, p_trunc, _ = port_env.step(a)
        assert (p_r, p_term, p_trunc) == (float(j_r), bool(j_term), bool(j_trunc))
        if p_term:
            ends += 1
            j_obs, _ = jax_env.reset()
            p_obs, _ = port_env.reset()
    assert ends == 3


@pytest.mark.parametrize("env_id", IDS)
def test_torch_counter_envs_spaces_are_jax_s(env_id):
    jax_env, port_env = _pair(env_id)
    spaces = port_env.spaces
    for k in ("rgb", "state"):
        assert tuple(spaces["obs"][k]["shape"]) == jax_env.observation_space[k].shape
        assert np.dtype(spaces["obs"][k]["dtype"]) == jax_env.observation_space[k].dtype
    space = jax_env.action_space
    actions = spaces["actions"]
    if env_id == "continuous_dummy":
        assert actions["continuous"] and tuple(actions["shape"]) == space.shape
        np.testing.assert_array_equal(actions["low"], space.low)
        np.testing.assert_array_equal(actions["high"], space.high)
    elif env_id == "multidiscrete_dummy":
        assert not actions["continuous"] and actions["n"] == space.nvec.tolist()
    else:
        assert not actions["continuous"] and actions["n"] == [int(space.n)]


def test_torch_counter_envs_vector_episodes_and_screen_size():
    cfg = apply_overrides(preset("ppo"), ["env.id=discrete_dummy", "env.num_envs=2", "env.screen_size=32"] + KEYS)
    envs = make_vector_env(cfg, 0)
    obs, _ = envs.reset(seed=0)
    assert obs["rgb"].shape == (2, 32, 32, 3) and obs["state"].shape == (2, 10)
    episodes = []
    for t in range(1, 16):
        obs, rewards, terminated, truncated, info = envs.step(np.zeros((2, 1), np.int64))
        assert not truncated.any() and (rewards == 0).all()
        if terminated.any():
            assert terminated.all() and t % 5 == 0
            assert (info["final_obs"][0]["state"] == 5).all() and (obs["state"] == 0).all()
            episodes += info["episodes"]
        else:
            assert (obs["state"] == t % 5).all() and (obs["rgb"] == t % 5).all()
    assert [(i, ret, length) for i, ret, length in episodes] == [(0, 0.0, 5), (1, 0.0, 5)] * 3


def test_torch_counter_envs_need_their_keys():
    assert sorted(COUNTER_ENVS) == IDS
    with pytest.raises(ValueError, match="rgb"):
        make_env(apply_overrides(preset("ppo"), ["env.id=discrete_dummy", "algo.mlp_keys.encoder=[obs]"]), 0)
