"""The port's env wrappers (``sheeprl_tpu_torch/envs/wrappers.py``) and the
wrapper chain of its ``make_env`` against the JAX package's
(``sheeprl_tpu/envs/wrappers.py`` and ``factory.make_env``), on the CPU.

Through the factories, with the same config keys: the JAX env (gymnasium
CartPole-v1, Pendulum-v1, MountainCar-v0, or the JAX counter dummies) and
the port's, fed the same actions from one seed over several episodes, give
the same observations (every key, dtype and shape), rewards and flags,
exactly; their observation spaces have the same keys and shapes. The chain
is exercised key by key (``action_repeat``, ``mask_velocities``,
``frame_stack`` with ``frame_stack_dilation``, ``actions_as_observation``
for a Box, a Discrete and a MultiDiscrete action, ``reward_as_observation``)
and all at once. Then the primitives (``DilatedDeque``, ``encode_action``)
against JAX's, exactly, and every check the JAX wrappers make, raised by
both sides."""

import gymnasium as gym
import numpy as np
import pytest

from sheeprl_tpu.config import compose
from sheeprl_tpu.envs import wrappers as J
from sheeprl_tpu.envs.factory import make_env as jax_make_env
from sheeprl_tpu_torch.config import RUN_DEFAULTS, apply_overrides, merge, plain, preset
from sheeprl_tpu_torch.envs import make_env
from sheeprl_tpu_torch.envs import wrappers as W
from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

PIXELS = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"]
VECTOR = ["algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]

#: case id -> (env group of the JAX config, env id, keys, the env.* overrides)
CASES = {
    "repeat": ("dummy", "continuous_dummy", PIXELS, ["env.action_repeat=3"]),
    "repeat_cartpole": ("gym", "CartPole-v1", VECTOR, ["env.action_repeat=2"]),
    "mask_cartpole": ("gym", "CartPole-v1", VECTOR, ["env.mask_velocities=True"]),
    "mask_pendulum": ("gym", "Pendulum-v1", VECTOR, ["env.mask_velocities=True"]),
    "mask_mountain_car": ("gym", "MountainCar-v0", VECTOR, ["env.mask_velocities=True"]),
    "frame_stack": ("dummy", "discrete_dummy", PIXELS, ["env.frame_stack=3"]),
    "frame_stack_dilated": ("dummy", "multidiscrete_dummy", PIXELS,
                            ["env.frame_stack=2", "env.frame_stack_dilation=3"]),
    "actions_box": ("dummy", "continuous_dummy", PIXELS,
                    ["env.actions_as_observation.num_stack=3", "env.actions_as_observation.noop=0.0"]),
    "actions_discrete": ("gym", "CartPole-v1", VECTOR,
                         ["env.actions_as_observation.num_stack=4", "env.actions_as_observation.noop=0",
                          "env.actions_as_observation.dilation=2"]),
    "actions_multidiscrete": ("dummy", "multidiscrete_dummy", PIXELS,
                              ["env.actions_as_observation.num_stack=2", "env.actions_as_observation.noop=[1,0]"]),
    "reward_pendulum": ("gym", "Pendulum-v1", VECTOR, ["env.reward_as_observation=True"]),
    "whole_chain": ("dummy", "continuous_dummy", PIXELS,
                    ["env.action_repeat=2", "env.frame_stack=2", "env.frame_stack_dilation=2",
                     "env.actions_as_observation.num_stack=2", "env.actions_as_observation.noop=0.5",
                     "env.reward_as_observation=True"]),
    "whole_chain_mountain_car": ("gym", "MountainCar-v0", VECTOR,
                                 ["env.action_repeat=3", "env.mask_velocities=True",
                                  "env.actions_as_observation.num_stack=2", "env.actions_as_observation.noop=1",
                                  "env.reward_as_observation=True"]),
}


def port_config(env_id, overrides):
    return apply_overrides(merge(RUN_DEFAULTS, plain(preset("ppo"))), [f"env.id={env_id}"] + overrides)


def pair(case):
    group, env_id, keys, env_overrides = CASES[case]
    jax_cfg = compose(["exp=ppo", f"env={group}", f"env.id={env_id}", "env.capture_video=False"] + keys + env_overrides)
    return jax_make_env(jax_cfg, 3, 0)(), make_env(port_config(env_id, keys + env_overrides), 3)


def _action(space, rng):
    if "n" in space:
        return np.asarray([rng.integers(0, n) for n in space["n"]]) if len(space["n"]) > 1 else int(rng.integers(0, space["n"][0]))
    return rng.uniform(-1, 1, size=space["shape"]).astype(np.float32)


def _same_obs(got, want, step):
    assert set(got) == set(want), step
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (step, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {step}, key {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_torch_env_wrappers_chain_steps_like_jax(case):
    jax_env, port_env = pair(case)
    rng = np.random.default_rng(0)
    j_obs, _ = jax_env.reset(seed=3)
    p_obs, _ = port_env.reset(seed=3)
    _same_obs(p_obs, j_obs, "reset")
    ends, steps = 0, 0
    while (ends < 2 or steps < 20) and steps < 700:
        a = _action(port_env.spaces["actions"], rng)
        j_obs, j_r, j_term, j_trunc, _ = jax_env.step(a)
        p_obs, p_r, p_term, p_trunc, _ = port_env.step(a)
        steps += 1
        _same_obs(p_obs, j_obs, steps)
        assert (p_r, p_term, p_trunc) == (j_r, bool(j_term), bool(j_trunc)), steps
        if p_term or p_trunc:
            ends += 1
            j_obs, _ = jax_env.reset()
            p_obs, _ = port_env.reset()
            _same_obs(p_obs, j_obs, f"reset after {steps}")
    assert ends >= 2
    spaces = port_env.spaces["obs"]
    assert set(spaces) == set(jax_env.observation_space.spaces)
    for k, space in jax_env.observation_space.spaces.items():
        assert tuple(spaces[k]["shape"]) == space.shape, k


def test_torch_env_wrappers_dilated_deque_matches_jax():
    rng = np.random.default_rng(1)
    for size, dilation in ((1, 1), (3, 1), (2, 3), (4, 2)):
        ours, theirs = W.DilatedDeque(size, dilation), J.DilatedDeque(size, dilation)
        first = rng.normal(size=(2, 3)).astype(np.float32)
        ours.fill(first)
        theirs.fill(first)
        for _ in range(9):
            item = rng.normal(size=(2, 3)).astype(np.float32)
            ours.push(item)
            theirs.push(item)
            np.testing.assert_array_equal(ours.snapshot(), theirs.snapshot())
        ours.pad_with_last()
        theirs.pad_with_last()
        np.testing.assert_array_equal(ours.snapshot(), theirs.snapshot())
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            J.DilatedDeque(*bad)
        with pytest.raises(ValueError):
            W.DilatedDeque(*bad)


@pytest.mark.parametrize("kind", ["box", "discrete", "multidiscrete"])
def test_torch_env_wrappers_encode_action_matches_jax(kind):
    rng = np.random.default_rng(2)
    if kind == "box":
        space, spec = gym.spaces.Box(-1, 1, (3,)), {"shape": [3], "continuous": True}
        actions = [rng.uniform(-1, 1, 3).astype(np.float32) for _ in range(5)]
    elif kind == "discrete":
        space, spec = gym.spaces.Discrete(4), {"n": [4], "continuous": False}
        actions = [int(a) for a in rng.integers(0, 4, 5)] + [np.int64(2)]
    else:
        space, spec = gym.spaces.MultiDiscrete([2, 3]), {"n": [2, 3], "continuous": False}
        actions = [np.array([a, b]) for a, b in rng.integers(0, 2, (5, 2))]
    for a in actions:
        got, want = W.encode_action(a, spec), J.encode_action(a, space)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize(
    "spec, space, noop",
    [
        ({"shape": [2], "low": [-1, -1], "high": [1, 1], "continuous": True}, gym.spaces.Box(-1, 1, (2,)), [0.0]),
        ({"n": [3], "continuous": False}, gym.spaces.Discrete(3), 0.5),
        ({"n": [3], "continuous": False}, gym.spaces.Discrete(3), [0]),
        ({"n": [2, 2], "continuous": False}, gym.spaces.MultiDiscrete([2, 2]), 0),
        ({"n": [2, 2], "continuous": False}, gym.spaces.MultiDiscrete([2, 2]), [0, 0, 1]),
        ({"n": [3], "continuous": False}, gym.spaces.Discrete(3), "noop"),
    ],
    ids=["box_list", "discrete_float", "discrete_list", "multi_scalar", "multi_length", "string"],
)
def test_torch_env_wrappers_noop_checks_raise_as_jax(spec, space, noop):
    class _Jax(gym.Env):
        action_space = space
        observation_space = gym.spaces.Dict({"state": gym.spaces.Box(-1, 1, (2,))})

    class _Port(ContinuousDummyEnv):
        @property
        def spaces(self):
            return {"obs": {"state": {"shape": [2], "dtype": "float32"}}, "actions": spec}

    want = _error(lambda: J.ActionsAsObservationWrapper(_Jax(), num_stack=2, noop=noop))
    got = _error(lambda: W.ActionsAsObservationWrapper(_Port(), num_stack=2, noop=noop))
    assert want is not None and got is want
    for bad in ({"num_stack": 0, "noop": 0}, {"num_stack": 2, "noop": 0, "dilation": 0}):
        assert _error(lambda: W.ActionsAsObservationWrapper(_Port(), **bad)) is ValueError


def test_torch_env_wrappers_chain_refuses_what_jax_refuses():
    # masking an env outside the velocity table raises, as in JAX (Acrobot has no entry)
    jax_cfg = compose(["exp=ppo", "env=gym", "env.id=Acrobot-v1", "env.capture_video=False",
                       "env.mask_velocities=True"] + VECTOR)
    with pytest.raises(NotImplementedError):
        jax_make_env(jax_cfg, 0, 0)()
    with pytest.raises(NotImplementedError, match="Acrobot-v1"):
        make_env(port_config("Acrobot-v1", VECTOR + ["env.mask_velocities=True"]), 0)
    with pytest.raises(NotImplementedError):
        make_env(port_config("continuous_dummy", PIXELS + ["env.mask_velocities=True"]), 0)
    # a frame stack dilation of 0 raises on both sides
    bad = ["env.frame_stack=2", "env.frame_stack_dilation=0"]
    with pytest.raises(ValueError, match="dilation"):
        jax_make_env(compose(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False"]
                             + PIXELS + bad), 0, 0)()
    with pytest.raises(ValueError, match="dilation"):
        make_env(port_config("discrete_dummy", PIXELS + bad), 0)
    # no video, no grayscale frames: said, not ignored
    with pytest.raises(ValueError, match="capture_video"):
        make_env(port_config("CartPole-v1", VECTOR + ["env.capture_video=True"]), 0)
    with pytest.raises(NotImplementedError, match="grayscale"):
        make_env(port_config("continuous_dummy", PIXELS + ["env.grayscale=True"]), 0)
    # keys the env does not have
    with pytest.raises(ValueError, match="not a subset"):
        make_env(port_config("discrete_dummy", ["algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[foo]"]), 0)


def test_torch_env_wrappers_atari_dummy_keeps_its_own_frame_skip():
    """The Atari-protocol dummy skips frames itself: no ActionRepeat on top
    (which would square the repeat), as the JAX factory decides."""
    cfg = apply_overrides(merge(RUN_DEFAULTS, plain(preset("dreamer_v3_100k_atari_dummy"))), [])
    env = make_env(cfg, 5)
    assert not isinstance(env, W.ActionRepeat) and env.frame_skip == 4
