"""``env.action_repeat`` on the envs that do not skip frames themselves:
the port's ``make_env`` for ``preset=dreamer_v3_continuous_dummy`` (action
repeat 2, the JAX ``exp=dreamer_v3_dmc_walker_walk`` value) builds the env
the JAX factory builds for the same keys
(``ActionRepeat<ContinuousDummyEnv>``): fed the same actions, the same
observations (every key), rewards (summed over the repeat) and flags, step
by step over three episodes, exactly; each episode as long as JAX's (the
counter advances 2 per agent step and the episode ends on the agent step
whose first repeat finds it at 128). Through the vector env the episodes
have that length too."""

import numpy as np
import pytest

from sheeprl_tpu.config import compose
from sheeprl_tpu.envs.factory import make_env as jax_make_env
from sheeprl_tpu_torch.config import RUN_DEFAULTS, apply_overrides, dotdict, merge, plain, preset
from sheeprl_tpu_torch.envs import make_env, make_vector_env

PRESET = "dreamer_v3_continuous_dummy"


def port_config(overrides=()):
    return apply_overrides(merge(RUN_DEFAULTS, plain(preset(PRESET))), list(overrides))


def jax_env():
    """The JAX factory's env for the preset's env id, action repeat and keys."""
    cfg = port_config()
    keys = [f"algo.cnn_keys.encoder=[{','.join(cfg.algo.cnn_keys.encoder)}]",
            f"algo.mlp_keys.encoder=[{','.join(cfg.algo.mlp_keys.encoder)}]"]
    jax_cfg = compose(["exp=dreamer_v3", "env=dummy", f"env.id={cfg.env.id}", "env.capture_video=False",
                       f"env.action_repeat={cfg.env.action_repeat}", f"env.screen_size={cfg.env.screen_size}"] + keys)
    return jax_make_env(jax_cfg, int(cfg.seed), 0)()


def jax_episode_length() -> int:
    """The agent steps of one episode of the JAX factory's env for the preset."""
    env = jax_env()
    env.reset(seed=0)
    steps, done = 0, False
    while not done:
        _, _, terminated, truncated, _ = env.step(np.zeros(env.action_space.shape, np.float32))
        steps += 1
        done = terminated or truncated
    return steps


def test_torch_action_repeat_preset_env_steps_like_jax():
    cfg = port_config()
    assert int(cfg.env.action_repeat) == 2
    j_env, p_env = jax_env(), make_env(cfg, int(cfg.seed))
    rng = np.random.default_rng(0)
    j_obs, _ = j_env.reset(seed=5)
    p_obs, _ = p_env.reset(seed=5)
    lengths, steps = [], 0
    while len(lengths) < 3:
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(p_obs[k], j_obs[k], err_msg=f"{k} after {steps} steps")
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        j_obs, j_r, j_term, j_trunc, _ = j_env.step(a)
        p_obs, p_r, p_term, p_trunc, _ = p_env.step(a)
        steps += 1
        assert (p_r, p_term, p_trunc) == (j_r, bool(j_term), bool(j_trunc)), steps
        if p_term or p_trunc:
            np.testing.assert_array_equal(p_obs["state"], j_obs["state"])
            lengths.append(steps)
            steps = 0
            j_obs, _ = j_env.reset()
            p_obs, _ = p_env.reset()
    assert lengths == [jax_episode_length()] * 3
    assert int(p_obs["state"][0]) == 0


@pytest.mark.parametrize("num_envs", [1, 3])
def test_torch_action_repeat_vector_episodes_are_jax_long(num_envs):
    length = jax_episode_length()
    envs = make_vector_env(port_config([f"env.num_envs={num_envs}"]), 5)
    envs.reset(seed=5)
    ended = []
    for _ in range(2 * length):
        _, rewards, _, _, infos = envs.step(np.zeros((num_envs, 2), np.float32))
        assert np.all(rewards == 0.0)
        ended += [ep_len for _, _, ep_len in infos.get("episodes", ())]
    assert ended == [length] * (2 * num_envs)


def test_torch_action_repeat_counter_advances_by_the_repeat():
    for repeat in (1, 2, 3):
        env = make_env(dotdict(port_config([f"env.action_repeat={repeat}"])), 5)
        obs, _ = env.reset(seed=5)
        for t in range(1, 6):
            obs, *_ = env.step(np.zeros(2, np.float32))
            assert obs["state"][0] == repeat * t and obs["rgb"][0, 0, 0] == repeat * t
