"""The port's stateless serving on the CPU: the PPO and SAC policy builders
against the JAX package's (``serve_policy_ppo``, ``serve_policy_sac``, built
as ``tests/test_serve/conftest.py`` builds them) under weights carried
across by ``ppo_state_from_jax`` / ``sac_state_from_jax``; the scheduler's
stateless batch path; the server's engine choice; and a socket round trip
through the ``serve`` entry point.

Tolerances: PPO's actions (argmax indices) are equal, greedy and sampled.
SAC's actions, greedy and sampled (fed JAX's own normals), within atol
4e-6 on Pendulum-shaped observations (cos, sin, and an angular velocity up
to 8): float32 products summed in another order by XLA and by PyTorch, then
``tanh`` and the action scale of 2; the largest difference measured over
16,384 such rows was 1.85e-6, 8 ulps of an action near 2.
"""

import socket
import threading
import time

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.evaluate import serve_policy_ppo as jax_serve_policy_ppo
from sheeprl_tpu.algos.sac.evaluate import serve_policy_sac as jax_serve_policy_sac
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo
from sheeprl_tpu_torch.algos.sac.evaluate import serve_policy_sac, standard_normal
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.serve.engine import BucketEngine, NaiveEngine
from sheeprl_tpu_torch.serve.scheduler import RequestScheduler
from sheeprl_tpu_torch.serve.server import PolicyServer, request_over_socket
from sheeprl_tpu_torch.serve.weights import WeightStore
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax, sac_state_from_jax

from tests.test_torch_serve_engine import toy_policy

JAX_COMMON = ["env=gym", "env.capture_video=False", "fabric.devices=1", "metric.log_level=0", "algo.mlp_keys.encoder=[state]"]
PPO_CASES = {"discrete": (4, (2,)), "multi-discrete": (6, (3, 4))}
_TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fabric():
    return Fabric(devices=1, accelerator="cpu")


def _perturbed(params, seed):
    """Every flax leaf moved, so the zero-initialised biases are carried too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32), params)


def ppo_pair(case):
    obs_dim, actions_dim = PPO_CASES[case]
    cfg = compose(["exp=ppo"] + JAX_COMMON)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    act_space = gym.spaces.Discrete(actions_dim[0]) if len(actions_dim) == 1 else gym.spaces.MultiDiscrete(list(actions_dim))
    jax_policy = jax_serve_policy_ppo(_fabric(), cfg, obs_space, act_space, None)
    params = _perturbed(jax_policy.params, 1)
    port_cfg = preset("ppo")
    port_cfg["spaces"] = {"obs": {"state": {"shape": [obs_dim], "dtype": "float32"}},
                          "actions": {"n": list(actions_dim), "continuous": False}}
    port = serve_policy_ppo(apply_overrides(port_cfg, []), {"agent": ppo_state_from_jax(params)}, "cpu")
    return jax_policy, params, port


def sac_pair():
    cfg = compose(["exp=sac", "env.id=Pendulum-v1"] + JAX_COMMON)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    jax_policy = jax_serve_policy_sac(_fabric(), cfg, obs_space, act_space, None)
    params = _perturbed(jax_policy.params, 2)
    port_cfg = preset("sac")
    port_cfg["spaces"] = {"obs": {"state": {"shape": [3], "dtype": "float32"}},
                          "actions": {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True}}
    port = serve_policy_sac(apply_overrides(port_cfg, []), {"agent": sac_state_from_jax(params)}, "cpu")
    return jax_policy, params, port


def _raw(rng, dim, n):
    return {"state": (rng.normal(size=(n, dim)) * 2).astype(np.float32)}


def _t(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


@pytest.mark.parametrize("case", list(PPO_CASES))
def test_torch_serve_stateless_ppo_builder_matches_jax(case):
    jax_policy, params, port = ppo_pair(case)
    obs_dim, actions_dim = PPO_CASES[case]
    assert port.obs_spec == jax_policy.obs_spec and port.action_dim == jax_policy.action_dim == len(actions_dim)
    assert port.name == jax_policy.name == "ppo"
    rng = np.random.default_rng(3)
    n = 64
    raw = _raw(rng, obs_dim, n)
    jax_obs, port_obs = jax_policy.prepare(raw, n), port.prepare(raw, n)
    for k in jax_obs:
        np.testing.assert_array_equal(port_obs[k], np.asarray(jax_obs[k]))
    with torch.no_grad():
        greedy = port.greedy_fn(port.params, _t(port_obs)).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(jax_policy.greedy_fn(params, jax_obs)))
    for seed in range(3):  # JAX's categorical draws, rebuilt from its key
        key = jax.random.PRNGKey(seed)
        uniforms = [
            torch.from_numpy(np.array(jax.random.uniform(k, (n, d), minval=_TINY, maxval=1.0)))
            for k, d in zip(jax.random.split(key, len(actions_dim)), actions_dim)
        ]
        with torch.no_grad():
            sampled = port.sample_fn(port.params, _t(port_obs), uniforms).numpy()
        want = np.asarray(jax_policy.sample_fn(params, jax_obs, key))
        np.testing.assert_array_equal(sampled, want)
        assert not np.array_equal(sampled, greedy)


def _pendulum_obs(rng, n):
    theta, speed = rng.uniform(-np.pi, np.pi, n), rng.uniform(-8.0, 8.0, n)
    return {"state": np.stack([np.cos(theta), np.sin(theta), speed], axis=-1).astype(np.float32)}


def test_torch_serve_stateless_sac_builder_matches_jax():
    jax_policy, params, port = sac_pair()
    assert port.obs_spec == jax_policy.obs_spec and port.action_dim == jax_policy.action_dim == 1
    rng = np.random.default_rng(4)
    n = 256
    raw = _pendulum_obs(rng, n)
    jax_obs, port_obs = jax_policy.prepare(raw, n), port.prepare(raw, n)
    np.testing.assert_array_equal(port_obs["obs"], np.asarray(jax_obs["obs"]))
    with torch.no_grad():
        greedy = port.greedy_fn(port.params, _t(port_obs)).numpy()
    np.testing.assert_allclose(greedy, np.asarray(jax_policy.greedy_fn(params, jax_obs)), rtol=0, atol=4e-6)
    for seed in range(3):  # JAX's own normals
        key = jax.random.PRNGKey(seed)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (n, 1), dtype=jnp.float32)))
        with torch.no_grad():
            sampled = port.sample_fn(port.params, _t(port_obs), noise).numpy()
        np.testing.assert_allclose(sampled, np.asarray(jax_policy.sample_fn(params, jax_obs, key)), rtol=0, atol=4e-6)


def test_torch_serve_stateless_draws_are_per_row_and_finite():
    """The builders' draws: one uniform tensor per PPO head and SAC's
    normals, each row a function of its own seed and counter only."""
    _, _, ppo = ppo_pair("multi-discrete")
    seeds, counters = torch.full((6,), 3, dtype=torch.int64), torch.arange(6, dtype=torch.int64)
    draws = ppo.draw_fn(seeds, counters)
    assert [tuple(u.shape) for u in draws] == [(6, 3), (6, 4)]
    assert all(bool(((u > 0) & (u < 1)).all()) for u in draws)
    alone = ppo.draw_fn(seeds[4:5], counters[4:5])
    for u, a in zip(draws, alone):
        assert torch.equal(u[4:5], a)
    normals = standard_normal(torch.full((4096,), 1, dtype=torch.int64), torch.arange(4096, dtype=torch.int64), 1)
    assert torch.isfinite(normals).all()
    assert abs(float(normals.mean())) < 0.05 and abs(float(normals.std()) - 1.0) < 0.05


def test_torch_serve_stateless_scheduler_keys_each_batch():
    """The stateless path: one ``infer`` per admitted batch over the
    concatenated rows; in sample mode batch ``i`` is keyed ``(seed, i)``;
    a ``session_id`` is refused."""
    policy = toy_policy()
    engine = BucketEngine(policy, buckets=(1, 4), mode="sample")
    keys = []
    real_infer = engine.infer
    engine.infer = lambda params, obs, key=None: keys.append(key) or real_infer(params, obs, key=key)
    sched = RequestScheduler(engine, WeightStore(policy.params), max_wait_s=0.0, seed=11).start()
    try:
        rng = np.random.default_rng(0)
        obs = [{"x": rng.normal(size=(2, 2)).astype(np.float32)} for _ in range(3)]
        got = [sched.result(sched.submit(o), timeout=30) for o in obs]
        with pytest.raises(ValueError, match="stateless"):
            sched.submit(obs[0], session_id="alice")
    finally:
        sched.stop()
    assert keys == [(11, 0), (11, 1), (11, 2)]
    for i, (o, (actions, version)) in enumerate(zip(obs, got)):
        assert version == 0
        np.testing.assert_array_equal(actions, real_infer(policy.params, o, key=(11, i)))
    assert sched.sessions is None and sched.max_batch == 4
    assert RequestScheduler(NaiveEngine(policy), WeightStore(policy.params)).max_batch == 128


def test_torch_serve_stateless_server_picks_the_engine_by_policy_type():
    policy = toy_policy()
    with PolicyServer(policy, {"buckets": [1, 8]}) as server:
        assert isinstance(server.engine, BucketEngine) and server.engine.buckets == (1, 8)
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        actions, version = server.client.act({"x": x}, n=3, timeout=30)
        np.testing.assert_array_equal(actions, x @ policy.params["w"].numpy())
        health = server.health()
        assert "sessions" not in health and health["engine"]["kind"] == "BucketEngine"
        assert health["engine"]["rows"] == 3 and health["engine"]["padded_rows"] == 5
    with PolicyServer(policy, {"engine": "naive"}) as server:
        assert isinstance(server.engine, NaiveEngine)
        np.testing.assert_array_equal(server.client.act({"x": x}, n=3, timeout=30)[0], actions)
    with pytest.raises(ValueError, match="aot|naive"):
        PolicyServer(policy, {"engine": "jit"})


def test_torch_serve_stateless_refuses_the_naive_engine_for_sessions():
    from tests.test_torch_serve_sessions import _policy

    with pytest.raises(ValueError, match="session engine"):
        PolicyServer(_policy(), {"engine": "naive"})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ask_when_up(addr, payload, deadline):
    while True:
        try:
            return request_over_socket(addr, payload)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_torch_serve_stateless_socket_round_trip(algo, tmp_path, capsys):
    """``serve`` on a port checkpoint of PPO or SAC: a request of raw rows
    over the socket gets each row's greedy action, a health probe shows the
    bucket engine, and ``serve.max_requests`` stops the server."""
    jax_policy, params, port = ppo_pair("discrete") if algo == "ppo" else sac_pair()
    cfg = preset(algo)
    cfg["spaces"] = {"obs": {"state": {"shape": [4 if algo == "ppo" else 3], "dtype": "float32"}},
                     "actions": ({"n": [2], "continuous": False} if algo == "ppo" else
                                 {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True})}
    state = {"agent": (ppo_state_from_jax if algo == "ppo" else sac_state_from_jax)(params)}
    ckpt = save_checkpoint(tmp_path / "checkpoint" / "ckpt_1_0.ckpt", state, plain(cfg))
    port_n = _free_port()
    done = threading.Event()
    thread = threading.Thread(
        target=lambda: (cli.serve([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", f"serve.port={port_n}",
                                   "serve.buckets=[1,8]", "serve.max_requests=3", "serve.log_every_s=600"]),
                        done.set()),
        daemon=True,
    )
    thread.start()
    addr = ("127.0.0.1", port_n)
    deadline = time.monotonic() + 60
    rng = np.random.default_rng(5)
    dim = port.obs_spec["obs" if algo == "sac" else "state"][0][0]
    for n in (1, 3, 12):
        raw = _raw(rng, dim, n) if algo == "ppo" else _pendulum_obs(rng, n)
        resp = _ask_when_up(addr, {"obs": {"state": raw["state"].tolist()}, "n": n}, deadline)
        assert resp["version"] == 0 and len(resp["actions"]) == n, resp
        with torch.no_grad():
            want = port.greedy_fn(port.params, _t(port.prepare(raw, n))).numpy()
        if algo == "ppo":
            np.testing.assert_array_equal(np.asarray(resp["actions"]), want)
        else:  # the server ran 12 rows as chunks of 8: matrix products at another batch size
            np.testing.assert_allclose(np.asarray(resp["actions"], np.float32), want, rtol=0, atol=4e-6)
        if n == 1:
            health = request_over_socket(addr, {"health": True})
            assert health["engine"]["kind"] == "BucketEngine" and health["engine"]["buckets"] == [1, 8]
            assert "sessions" not in health
    thread.join(timeout=60)
    assert done.is_set() and not thread.is_alive()
    out = capsys.readouterr().out
    assert f"serving {algo} on 127.0.0.1:{port_n}" in out and '"dispatches": 4' in out
