"""Recurrent PPO served as sessions, on the CPU:
``serve_policy_ppo_recurrent`` against the JAX package's builder (built as
its serving tests build it) under weights carried by
``ppo_recurrent_state_from_jax``, the port's ``SessionEngine`` over it,
and the ``serve`` entry point on a socket.

- 6 sessions x 24 greedy steps, each fed its own observations: every
  action equal to JAX's (argmax indices), the LSTM pair within atol 1e-5
  (torch's LSTM and XLA's scan sum the gates in another order), and the
  previous-action carry equal; a continuous head's greedy actions (the
  mean) within atol 1e-5.
- A batched row equals the row alone: actions equal, greedy and sampled
  (the draws are ``counter_uniform`` of the row's seed and step, equal
  bit for bit), the state within atol 1e-6 (a matmul over another batch
  size may round its last bit otherwise).
- A served greedy session fed the evaluation episode's observations gives
  the episode's actions step by step, through the engine and through the
  socket.
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

from sheeprl_tpu.algos.ppo_recurrent.evaluate import serve_policy_ppo_recurrent as jax_serve_policy
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo_recurrent import utils as rec_utils
from sheeprl_tpu_torch.algos.ppo_recurrent.evaluate import evaluate_ppo_recurrent, serve_policy_ppo_recurrent
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.serve.server import request_over_socket
from sheeprl_tpu_torch.serve.sessions import SessionEngine
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
from sheeprl_tpu_torch.utils.convert import ppo_recurrent_state_from_jax

N, STEPS = 6, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(spaces, extra=()):
    cfg = preset("ppo_recurrent")
    cfg["spaces"] = spaces
    return apply_overrides(cfg, list(extra))


def pair(continuous=False):
    cfg = compose(["exp=ppo_recurrent", "env.capture_video=False", "fabric.devices=1", "metric.log_level=0"])
    obs_dim = 10 if continuous else 4
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
    act_space = gym.spaces.Box(-1.0, 1.0, (2,), np.float32) if continuous else gym.spaces.Discrete(2)
    jax_policy = jax_serve_policy(Fabric(devices=1, accelerator="cpu"), cfg, obs_space, act_space, None)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32),
                          jax_policy.params)
    actions = ({"shape": [2], "low": [-1.0, -1.0], "high": [1.0, 1.0], "continuous": True} if continuous
               else {"n": [2], "continuous": False})
    port_cfg = _port_cfg({"obs": {"state": {"shape": [obs_dim], "dtype": "float32"}}, "actions": actions})
    port = serve_policy_ppo_recurrent(port_cfg, {"agent": ppo_recurrent_state_from_jax(params)}, "cpu")
    return jax_policy, params, port, obs_dim


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_torch_serve_recurrent_greedy_sessions_match_jax(continuous):
    jax_policy, params, port, obs_dim = pair(continuous)
    assert port.obs_spec == jax_policy.obs_spec and port.action_dim == jax_policy.action_dim
    rng = np.random.default_rng(5)
    j_state = jax_policy.init_fn(params, N)
    with torch.no_grad():
        p_state = port.init_fn(port.params, N)
    assert set(p_state) == {"hx", "cx", "prev_actions", "seed", "counter"}
    for _ in range(STEPS):
        raw = {"state": (rng.normal(size=(N, obs_dim)) * 2).astype(np.float32)}
        j_obs, p_obs = jax_policy.prepare(raw, N), port.prepare(raw, N)
        np.testing.assert_array_equal(p_obs["state"], np.asarray(j_obs["state"]))
        j_act, j_state = jax_policy.step_fn(params, j_obs, j_state, jax.random.PRNGKey(0), True)
        with torch.no_grad():
            p_act, p_state = port.step_fn(port.params, _t(p_obs), p_state, True)
        if continuous:
            np.testing.assert_allclose(p_act.numpy(), np.asarray(j_act), atol=1e-5)
            np.testing.assert_allclose(p_state["prev_actions"].numpy(), np.asarray(j_state["prev_actions"]), atol=1e-5)
        else:
            np.testing.assert_array_equal(p_act.numpy(), np.asarray(j_act))
            np.testing.assert_array_equal(p_state["prev_actions"].numpy(), np.asarray(j_state["prev_actions"]))
        for k in ("hx", "cx"):
            np.testing.assert_allclose(p_state[k].numpy(), np.asarray(j_state[k]), atol=1e-5, err_msg=k)
    assert p_state["counter"].tolist() == [STEPS] * N


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sample"])
def test_torch_serve_recurrent_batched_row_equals_the_row_alone(greedy):
    _, _, port, obs_dim = pair()
    rng = np.random.default_rng(6)
    with torch.no_grad():
        batch_state = port.init_fn(port.params, N)
        batch_state["seed"] = torch.arange(N, dtype=torch.int64) + 40
        alone = [{k: v[i:i + 1].clone() for k, v in batch_state.items()} for i in range(N)]
        seen = set()
        for _ in range(STEPS):
            obs = _t(port.prepare({"state": rng.normal(size=(N, obs_dim)).astype(np.float32)}, N))
            acts, batch_state = port.step_fn(port.params, obs, batch_state, greedy)
            for i in range(N):
                a, alone[i] = port.step_fn(port.params, {k: v[i:i + 1] for k, v in obs.items()}, alone[i], greedy)
                torch.testing.assert_close(a, acts[i:i + 1], rtol=0, atol=0)
                for k in ("hx", "cx"):
                    torch.testing.assert_close(alone[i][k], batch_state[k][i:i + 1], rtol=0, atol=1e-6)
            seen.update(acts.reshape(-1).tolist())
    assert seen == {0, 1}


def _checkpoint(tmp_path, port):
    cfg = plain(_port_cfg({"obs": {"state": {"shape": [4], "dtype": "float32"}}, "actions": {"n": [2], "continuous": False}},
                          ["env.num_envs=1"]))
    return save_checkpoint(tmp_path / "run" / "ckpt_0.ckpt", {"agent": port.params.state_dict()}, cfg)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torch_serve_recurrent_session_replays_the_evaluation_episode(tmp_path, monkeypatch):
    _, _, port, _ = pair()
    ckpt = _checkpoint(tmp_path, port)
    seen_obs, seen_actions = [], []
    make_env = rec_utils.make_env

    class Recording:
        def __init__(self, env):
            self.env = env

        def reset(self, seed=None):
            obs, info = self.env.reset(seed=seed)
            seen_obs.append(obs["state"].copy())
            return obs, info

        def step(self, action):
            seen_actions.append(int(action))
            obs, *rest = self.env.step(action)
            seen_obs.append(obs["state"].copy())
            return (obs, *rest)

        def close(self):
            self.env.close()

    monkeypatch.setattr(rec_utils, "make_env", lambda cfg, seed: Recording(make_env(cfg, seed)))
    cfg = cli.compose_eval_config([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    result = evaluate_ppo_recurrent(cfg, {"agent": port.params.state_dict()}, torch.device("cpu"))
    assert result["steps"] == len(seen_actions) > 5

    engine = SessionEngine(port, buckets=(1, 4))
    served = [int(engine.step_sessions(port.params, port.prepare({"state": o[None]}, 1), ["ep"])[0][0])
              for o in seen_obs[: len(seen_actions)]]
    assert served == seen_actions

    sock_port = _free_port()
    n = min(len(seen_actions), 12)
    args = [f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", f"serve.port={sock_port}",
            "serve.session.buckets=[1,2]", f"serve.max_requests={n}", "serve.max_wait_ms=1"]
    t = threading.Thread(target=cli.serve, args=(args,), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    over_socket = []
    for o in seen_obs[:n]:
        while True:
            try:
                resp = request_over_socket(("127.0.0.1", sock_port), {"obs": {"state": o.tolist()}, "session_id": "ep"})
                break
            except OSError:
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.1)
        over_socket.append(resp["actions"][0][0])
    t.join(timeout=30)
    assert not t.is_alive()
    assert over_socket == seen_actions[:n]
