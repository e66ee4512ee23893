"""Acrobot-v1 and MountainCar-v0 (``sheeprl_tpu_torch/envs/classic.py``)
against gymnasium's, on the CPU: one seed, the same actions for 1,000 steps
with the resets that episode ends call for (termination or the 500- and
200-step limits), the observation, reward and flags step by step;
MountainCar's state bit for bit, Acrobot's float64 state within 1e-12 (the
same RK4 arithmetic; the bound exists for a libm that rounds a sine
differently). Then against the JAX package's float32 twins
(``sheeprl_tpu/envs/jax_envs/{acrobot,mountain_car}.py``), stepped from the
twin's state each step so the float32/float64 gap does not compound: the
observation within 1e-5, reward and termination equal. Then both through
``make_env`` and the vector env, with ``mask_velocities`` on MountainCar."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sheeprl_tpu.envs.jax_envs.acrobot import AcrobotState, JaxAcrobot
from sheeprl_tpu.envs.jax_envs.mountain_car import JaxMountainCar, MountainCarState
from sheeprl_tpu_torch.config import RUN_DEFAULTS, apply_overrides, merge, plain, preset
from sheeprl_tpu_torch.envs import make_env, make_vector_env
from sheeprl_tpu_torch.envs.classic import AcrobotEnv, MountainCarEnv

STEPS = 1000


@pytest.mark.parametrize("env_id, cls, atol", [("Acrobot-v1", AcrobotEnv, 1e-12), ("MountainCar-v0", MountainCarEnv, 0.0)])
def test_torch_classic_control_matches_gymnasium(env_id, cls, atol):
    ref = gym.make(env_id)
    port = cls(seed=11)
    want, _ = ref.reset(seed=11)
    got = port.reset()[0]["state"]
    np.testing.assert_array_equal(got, want)
    ends = terms = 0
    # MountainCar alternates episodes that push along the velocity (they reach
    # the flag) with random ones (truncated at 200 steps)
    pumping = env_id == "MountainCar-v0"
    actions = np.random.default_rng(7).integers(0, 3, size=STEPS)
    for t in range(STEPS):
        a = 2 if pumping and port.state[1] >= 0 else 0 if pumping else actions[t]
        want, w_r, w_term, w_trunc, _ = ref.step(int(a))
        got, g_r, g_term, g_trunc, _ = port.step(a)
        np.testing.assert_array_equal(got["state"], want, err_msg=f"step {t}")
        assert got["state"].dtype == want.dtype == np.float32
        np.testing.assert_allclose(np.asarray(port.state, np.float64), np.asarray(ref.unwrapped.state, np.float64),
                                   atol=atol, rtol=0, err_msg=f"step {t}")
        assert (g_r, g_term, g_trunc) == (w_r, w_term, w_trunc), t
        if g_term or g_trunc:
            ends += 1
            terms += int(g_term)
            pumping = not pumping if env_id == "MountainCar-v0" else pumping
            want, _ = ref.reset()
            got = port.reset()[0]["state"]
            np.testing.assert_array_equal(got, want, err_msg=f"reset after {t}")
    assert ends >= 2 and terms >= 1


def test_torch_classic_control_acrobot_matches_the_jax_twin():
    twin, port = JaxAcrobot(), AcrobotEnv(seed=3)
    port.reset()
    state = AcrobotState(physics=jnp.asarray(port.state), t=jnp.zeros((), jnp.int32))
    step = jax.jit(twin.step)
    rng = np.random.default_rng(5)
    for t in range(500):
        a = int(rng.integers(3))
        port.state = np.asarray(state.physics, dtype=np.float32)
        state, j_obs, j_rew, _, info = step(state, jnp.int32(a))
        got, reward, term, _, _ = port.step(a)
        np.testing.assert_allclose(got["state"], np.asarray(j_obs), atol=1e-5, rtol=1e-5, err_msg=f"step {t}")
        assert reward == float(j_rew) and term == bool(info["terminated"]), t
        if term:
            port.reset()
            state = AcrobotState(physics=jnp.asarray(port.state), t=jnp.zeros((), jnp.int32))


def test_torch_classic_control_mountain_car_matches_the_jax_twin():
    twin, port = JaxMountainCar(), MountainCarEnv(seed=3)
    port.reset()
    state = MountainCarState(physics=jnp.asarray(port.state, jnp.float32), t=jnp.zeros((), jnp.int32))
    step = jax.jit(twin.step)
    terms = 0
    for t in range(600):
        a = 2 if float(state.physics[1]) >= 0 else 0
        port.state = np.asarray(state.physics, dtype=np.float64)
        state, j_obs, j_rew, _, info = step(state, jnp.int32(a))
        got, reward, term, _, _ = port.step(a)
        np.testing.assert_allclose(got["state"], np.asarray(j_obs), atol=1e-5, rtol=1e-5, err_msg=f"step {t}")
        assert reward == float(j_rew) and term == bool(info["terminated"]), t
        if term:
            terms += 1
            port.reset()
            state = MountainCarState(physics=jnp.asarray(port.state, jnp.float32), t=jnp.zeros((), jnp.int32))
    assert terms >= 2


@pytest.mark.parametrize("env_id, obs_dim, limit", [("Acrobot-v1", 6, 500), ("MountainCar-v0", 2, 200)])
def test_torch_classic_control_through_make_env(env_id, obs_dim, limit):
    cfg = apply_overrides(merge(RUN_DEFAULTS, plain(preset("ppo"))), [f"env.id={env_id}", "env.num_envs=2"])
    env = make_env(cfg, 0)
    assert env.spaces == {"obs": {"state": {"shape": [obs_dim], "dtype": "float32"}},
                          "actions": {"n": [3], "continuous": False}}
    envs = make_vector_env(cfg, 0)
    obs, _ = envs.reset(seed=0)
    assert obs["state"].shape == (2, obs_dim)
    lengths = []
    for _ in range(limit):
        obs, rewards, term, trunc, infos = envs.step(np.ones((2, 1), np.int64))  # no torque / no push
        assert np.all(rewards == -1.0)
        lengths += [ep_len for _, _, ep_len in infos.get("episodes", ())]
    assert lengths == [limit, limit]  # neither reaches its goal doing nothing: truncated at the limit


def test_torch_classic_control_mountain_car_masks_its_velocity():
    cfg = apply_overrides(merge(RUN_DEFAULTS, plain(preset("ppo"))),
                          ["env.id=MountainCar-v0", "env.mask_velocities=true"])
    env, plain_env = make_env(cfg, 4), MountainCarEnv(seed=4)
    obs, ref = env.reset(seed=4)[0]["state"], plain_env.reset(seed=4)[0]["state"]
    for _ in range(20):
        assert obs[1] == 0.0 and obs[0] == ref[0]
        obs, ref = env.step(2)[0]["state"], plain_env.step(2)[0]["state"]
    assert ref[1] != 0.0
