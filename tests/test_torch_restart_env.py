"""``RestartOnException`` and the Dreamer loops' ``restart_on_exception``
buffer patch, on the CPU:

- the wrapper (``wait=0``) against the JAX package's on an env that raises on
  scheduled steps: the same observations, rewards and flags step by step; a
  failed step comes back as the fresh env's reset observation with reward 0,
  neither terminated nor truncated, and ``info["restart_on_exception"]``;
  a failed reset likewise; an exception it was not given passes through;
- the ``maxfails`` window: a failure past ``maxfails`` inside ``window``
  seconds raises, and a failure after the window has passed starts a new
  count;
- the vector env reports the flag per env and starts that env's episode
  counters again;
- the patch: the env's last stored row becomes truncated, not terminated and
  not first, the next row first, unless the step also ended the episode; on
  the ring driver the staged row is patched;
- a DreamerV3 run on the host buffer whose env crashes once mid-episode:
  the stored rows carry the patch, and the run trains on.
"""

import functools

import gymnasium as gym
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.wrappers import RestartOnException as JaxRestartOnException
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.utils import patch_restarted_envs
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.envs import SyncVectorEnv
from sheeprl_tpu_torch.envs import vector as vector_module
from sheeprl_tpu_torch.envs.wrappers import RestartOnException
from tests.test_torch_train_loop import TINY_RUN


class Counter:
    """The step count as the observation, reward 1 a step; raises
    ``error`` on the steps (counted over every instance) in ``crash_at`` and
    on the resets in ``crash_resets``."""

    def __init__(self, clock, crash_at=(), crash_resets=(), error=RuntimeError):
        self.clock, self.crash_at, self.crash_resets, self.error = clock, crash_at, crash_resets, error
        self.t = 0

    def reset(self, seed=None, options=None):
        self.clock["resets"] += 1
        if self.clock["resets"] in self.crash_resets:
            raise self.error(f"reset {self.clock['resets']}")
        self.t = 0
        return {"state": np.array([self.t], np.float32)}, {"lives": 1}

    def step(self, action):
        self.clock["steps"] += 1
        if self.clock["steps"] in self.crash_at:
            raise self.error(f"step {self.clock['steps']}")
        self.t += 1
        return {"state": np.array([self.t], np.float32)}, 1.0, self.t == 6, False, {"lives": 1}

    def close(self):
        pass

    @property
    def spaces(self):
        return {"obs": {"state": {"shape": [1], "dtype": "float32"}}, "actions": {"n": [2], "continuous": False}}


class GymCounter(gym.Env):
    """:class:`Counter` as a gymnasium env, for the JAX wrapper."""

    observation_space = gym.spaces.Dict({"state": gym.spaces.Box(0, 100, (1,), np.float32)})
    action_space = gym.spaces.Discrete(2)

    def __init__(self, clock, **kw):
        self.inner = Counter(clock, **kw)

    def reset(self, *, seed=None, options=None):
        return self.inner.reset(seed, options)

    def step(self, action):
        return self.inner.step(action)


def _clock():
    return {"steps": 0, "resets": 0}


def test_torch_restart_env_matches_jax_step_by_step():
    ours_clock, jax_clock = _clock(), _clock()
    ours = RestartOnException(lambda: Counter(ours_clock, crash_at=(3, 9)), maxfails=2, wait=0)
    theirs = JaxRestartOnException(lambda: GymCounter(jax_clock, crash_at=(3, 9)), maxfails=2, wait=0)
    got, want = [ours.reset(seed=0)], [theirs.reset(seed=0)]
    for _ in range(12):
        got.append(ours.step(0))
        want.append(theirs.step(0))
    flags = []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0]["state"], w[0]["state"])
        assert g[1:-1] == w[1:-1] and g[-1] == w[-1]
        flags.append(bool(g[-1].get("restart_on_exception", False)))
    assert flags == [False, False, False, True] + [False] * 5 + [True] + [False] * 3
    obs, reward, term, trunc, info = got[3]
    assert obs["state"][0] == 0 and (reward, term, trunc) == (0.0, False, False) and info["lives"] == 1


def test_torch_restart_env_recovers_a_failed_reset():
    clock = _clock()
    env = RestartOnException(lambda: Counter(clock, crash_resets=(1,)), wait=0)
    obs, info = env.reset(seed=1)
    assert obs["state"][0] == 0 and info["restart_on_exception"] and clock["resets"] == 2


def test_torch_restart_env_passes_other_exceptions():
    env = RestartOnException(lambda: Counter(_clock(), crash_at=(1,), error=KeyError), exceptions=(ValueError,),
                             wait=0)
    env.reset()
    with pytest.raises(KeyError):
        env.step(0)


def test_torch_restart_env_maxfails_window(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr("sheeprl_tpu_torch.envs.wrappers.time.time", lambda: now[0])
    clock = _clock()
    env = RestartOnException(lambda: Counter(clock, crash_at=(1, 2, 3, 4, 5)), window=60, maxfails=2, wait=0)
    env.reset()
    assert env.step(0)[-1]["restart_on_exception"] and env.step(0)[-1]["restart_on_exception"]
    now[0] += 61  # past the window: the count starts again
    assert env.step(0)[-1]["restart_on_exception"] and env.step(0)[-1]["restart_on_exception"]
    with pytest.raises(RuntimeError, match="crashed too many times: 3"):
        env.step(0)
    clock = _clock()
    env = RestartOnException(lambda: Counter(clock, crash_at=(1, 2, 3)), window=60, maxfails=2, wait=0)
    env.reset()
    assert env.step(0)[-1]["restart_on_exception"] and env.step(0)[-1]["restart_on_exception"]
    with pytest.raises(RuntimeError, match="crashed too many times: 3"):
        env.step(0)


def test_torch_restart_env_vector_env_reports_the_restart():
    clocks = [_clock(), _clock()]
    envs = SyncVectorEnv([lambda c=c, at=at: RestartOnException(lambda: Counter(c, crash_at=at), wait=0)
                          for c, at in zip(clocks, ((4,), ()))])
    envs.reset(seed=0)
    for _ in range(3):
        _, _, _, _, infos = envs.step(np.zeros(2))
        assert "restart_on_exception" not in infos
    obs, rewards, term, trunc, infos = envs.step(np.zeros(2))
    assert infos["restart_on_exception"].tolist() == [True, False] and obs["state"][:, 0].tolist() == [0.0, 4.0]
    assert rewards.tolist() == [0.0, 1.0] and not term.any() and not trunc.any()
    assert envs._elapsed.tolist() == [1, 4] and envs._returns.tolist() == [0.0, 4.0]


def _buffer():
    rb = EnvIndependentReplayBuffer(8, 2, ["state"])
    rows = {"state": np.zeros((1, 2, 1), np.float32), "terminated": np.ones((1, 2, 1), np.float32),
            "truncated": np.zeros((1, 2, 1), np.float32), "is_first": np.ones((1, 2, 1), np.float32)}
    for _ in range(3):
        rb.add(rows)
    return rb


def test_torch_restart_env_patch_truncates_the_last_row():
    rb = _buffer()
    step_data = {"is_first": np.zeros((1, 2, 1), np.float32)}
    patch_restarted_envs(np.array([True, False]), np.array([False, False]), step_data, rb=rb)
    env0, env1 = rb.buffer
    assert (env0.buffer["terminated"][2, 0, 0], env0.buffer["truncated"][2, 0, 0], env0.buffer["is_first"][2, 0, 0]) \
        == (0.0, 1.0, 0.0)
    assert (env0.buffer["terminated"][1, 0, 0], env0.buffer["is_first"][1, 0, 0]) == (1.0, 1.0)  # older rows stay
    assert (env1.buffer["terminated"][2, 0, 0], env1.buffer["truncated"][2, 0, 0]) == (1.0, 0.0)
    assert step_data["is_first"][0, :, 0].tolist() == [1.0, 0.0]
    # a restart in the step that ended the episode patches nothing
    rb = _buffer()
    step_data = {"is_first": np.zeros((1, 2, 1), np.float32)}
    patch_restarted_envs(np.array([True, True]), np.array([True, True]), step_data, rb=rb)
    assert rb.buffer[0].buffer["terminated"][2, 0, 0] == 1.0 and not step_data["is_first"].any()


def test_torch_restart_env_patch_on_the_ring_driver():
    class Driver:
        def __init__(self):
            self.patched = []

        def patch_last(self, env_idx, updates):
            self.patched.append((env_idx, updates))

    driver = Driver()
    step_data = {"is_first": np.zeros((1, 3, 1), np.float32)}
    patch_restarted_envs(np.array([False, True, True]), np.array([False, False, True]), step_data, driver=driver)
    assert driver.patched == [(1, {"terminated": 0.0, "is_first": 0.0})]
    assert step_data["is_first"][0, :, 0].tolist() == [0.0, 1.0, 0.0]


class CrashOnce:
    """Wraps a port env; its ``at``-th step over every instance raises once."""

    def __init__(self, env, clock, at):
        self.env, self.clock, self.at = env, clock, at

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, action):
        self.clock[0] += 1
        if self.clock[0] == self.at:
            raise RuntimeError("the emulator died")
        return self.env.step(action)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)


def test_torch_restart_env_dreamer_v3_host_loop_patches_its_buffer(tmp_path, monkeypatch):
    """The env crashes at its 10th step: the buffer's row of step 9 (its
    observation and the action that crashed) is truncated, and the row of
    the fresh env's reset observation is first."""
    torch.set_num_threads(1)
    clock = [0]
    real_make_env = vector_module.make_env
    monkeypatch.setattr(vector_module, "make_env",
                        lambda cfg, seed: CrashOnce(real_make_env(cfg, seed), clock, at=10))
    monkeypatch.setattr(vector_module, "RestartOnException", functools.partial(RestartOnException, wait=0))
    s = cli.run(TINY_RUN + ["env.num_envs=1", "algo.total_steps=16", "algo.run_test=false", "buffer.checkpoint=true",
                            f"log_root={tmp_path}"])
    assert s["gradient_steps"] > 0 and np.isfinite(np.asarray(s["metrics"])).all()
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    rows = {k: v.numpy()[:, 0, 0] for k, v in load_checkpoint(s["checkpoint"])["rb"]["envs"][0]["buffer"].items()
            if k in ("terminated", "truncated", "is_first")}
    # row 0 holds the first observation; row t the observation of step t and the action taken on it
    assert rows["truncated"].tolist().index(1.0) == 9
    assert (rows["terminated"][9], rows["is_first"][9], rows["is_first"][10]) == (0.0, 0.0, 1.0)
    # the checkpoint's truncation patch (JAX's CheckpointCallback) also marks the newest row truncated
    assert rows["is_first"][:9].tolist() == [1.0] + [0.0] * 8 and rows["truncated"].sum() == 2
    assert rows["truncated"][-1] == 1
