"""The port's self-healing env (``fault.watchdog.SelfHealingEnv``) and
``fault.inject.FlakyEnv`` against the JAX package's, on the CPU, over
CartPole-v1 (the port's numpy CartPole, which gives gymnasium's numbers bit
for bit): the same fault schedule (a crash in ``step``, a crash in
``reset``, a hang past the watchdog's timeout) gives the same observations,
rewards, truncations, ``env_restarted`` flags and restart counts step by
step, and a rebuild budget that runs out raises the same error. Then the
vector env's ``env.restart_attempts`` wiring, through a PPO run whose env
crashes once.
"""

import gymnasium as gym
import numpy as np
import pytest

from sheeprl_tpu.fault.inject import FlakyEnv as JaxFlakyEnv
from sheeprl_tpu.fault.watchdog import EnvTimeoutError as JaxEnvTimeoutError
from sheeprl_tpu.fault.watchdog import SelfHealingEnv as JaxSelfHealingEnv
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.envs import vector
from sheeprl_tpu_torch.envs.classic import CartPoleEnv
from sheeprl_tpu_torch.fault import EnvTimeoutError, FlakyEnv, SelfHealingEnv

SIDES = {
    "jax": (lambda: gym.make("CartPole-v1"), JaxFlakyEnv, JaxSelfHealingEnv, lambda obs: np.asarray(obs)),
    "port": (lambda: CartPoleEnv(), FlakyEnv, SelfHealingEnv, lambda obs: np.asarray(obs["state"])),
}
SCHEDULES = {
    "step-crash": dict(fail_on="step", mode="raise", fuse=1, timeout=None),
    "two-step-crashes": dict(fail_on="step", mode="raise", fuse=2, timeout=None),
    "reset-crash": dict(fail_on="reset", mode="raise", fuse=1, timeout=None),
    "step-hang": dict(fail_on="step", mode="hang", fuse=1, timeout=0.2),
}


def _drive(side: str, schedule: dict, steps: int = 12):
    make, flaky, healing, obs_of = SIDES[side]
    fuse = [schedule["fuse"]]

    def thunk():
        inner = make()
        inner.reset(seed=7)  # each rebuilt env continues one seeded stream
        return flaky(inner, fuse, fail_on=schedule["fail_on"], mode=schedule["mode"], hang_seconds=1.0)

    env = healing(thunk, attempts=2, backoff=0.0, step_timeout=schedule["timeout"])
    obs, info = env.reset(seed=1)
    record = [("reset", obs_of(obs).tolist(), bool(info.get("env_restarted", False)))]
    actions = np.random.default_rng(0).integers(0, 2, steps)
    for a in actions:
        obs, reward, term, trunc, info = env.step(int(a))
        record.append(("step", obs_of(obs).tolist(), float(reward), bool(term), bool(trunc),
                       bool(info.get("env_restarted", False))))
        if term or trunc:
            obs, info = env.reset()
            record.append(("reset", obs_of(obs).tolist(), bool(info.get("env_restarted", False))))
    return record, env.restarts, fuse[0]


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_torch_fault_self_healing_env_matches_jax(schedule):
    with pytest.warns(UserWarning, match="recreating"):
        got = _drive("port", SCHEDULES[schedule])
    with pytest.warns(UserWarning, match="recreating"):
        want = _drive("jax", SCHEDULES[schedule])
    assert got == want
    record, restarts, fuse = got
    assert restarts == SCHEDULES[schedule]["fuse"] and fuse == 0
    assert sum(1 for r in record if r[-1]) == restarts  # each heal surfaces once, as a truncation or a reset


@pytest.mark.parametrize("side", ["port", "jax"])
def test_torch_fault_self_healing_env_budget_runs_out(side):
    make, _, healing, _ = SIDES[side]
    calls = {"n": 0}

    def dying():
        calls["n"] += 1
        if calls["n"] > 1:  # the first build works, every rebuild fails
            raise RuntimeError("factory down")
        return make()

    env = healing(dying, attempts=2, backoff=0.0)
    env.reset(seed=0)
    env.env.step = lambda a: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.warns(UserWarning, match="recreating"):
        with pytest.raises(RuntimeError, match="could not be recreated after 2 attempts"):
            env.step(0)
    assert calls["n"] == 3


def test_torch_fault_hang_without_a_heal_budget_is_a_timeout_error():
    """The watchdog's error names the call and the timeout, as JAX's does."""
    for healing, flaky, make, err in ((SelfHealingEnv, FlakyEnv, CartPoleEnv, EnvTimeoutError),
                                      (JaxSelfHealingEnv, JaxFlakyEnv, lambda: gym.make("CartPole-v1"),
                                       JaxEnvTimeoutError)):
        fuse = [1]
        env = healing(lambda: flaky(make(), fuse, mode="hang", hang_seconds=1.0), attempts=1, step_timeout=0.1)
        env.reset(seed=0)
        with pytest.raises(err, match="env.step exceeded 0.1s watchdog timeout"):
            env._call("step", 0)


def test_torch_fault_vector_env_restarts_reach_the_run_summary(tmp_path, monkeypatch):
    fuse = [1]
    real = vector.make_env
    monkeypatch.setattr(vector, "make_env", lambda cfg, seed: FlakyEnv(real(cfg, seed), fuse))
    with pytest.warns(UserWarning, match="recreating"):
        s = cli.run([
            "preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=16", "buffer.size=16",
            "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.total_steps=64", "metric.log_level=0",
            "algo.run_test=false", f"log_root={tmp_path}", "env.restart_attempts=2", "env.restart_backoff=0",
        ])
    assert s["Fault/env_restarts"] == 1 and fuse == [0] and s["iterations"] == 2
    # the heal cut an episode short: a truncated one-step episode
    assert any(ep_len == 1 for _, _, _, ep_len in s["episodes"])
