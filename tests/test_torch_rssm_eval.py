"""The port's DreamerV3 test episode and evaluation on the CPU.

- Against the JAX package's ``test`` (``sheeprl_tpu/algos/dreamer_v3/utils.py``),
  greedy, on the Atari-protocol dummy (64x64x3 pixels, 18 actions) at small
  widths, under weights carried across by ``dreamer_v3_state_from_jax``, step
  by step over the whole episode. The JAX player's posterior sample is
  teacher-forced, since the two frameworks never draw the same sample: each
  port step starts from the JAX state before it (action carry, recurrent
  state, posterior sample). The recurrent state and the representation
  logits (unimixed log-probabilities) within atol 1e-5; the actor's
  unimixed logits, on the JAX posterior, within atol 1e-5; the greedy
  actions equal.
- The episode is a serving session: a session served by the port's server,
  fed the episode's frames, gives the episode's actions, greedy and
  sampled.
- Its draws are counters: neither the training generator nor the global
  one moves. DreamerV3 ``run`` ends in the episode by default.
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import actor_dists as jax_actor_dists
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.utils import test as jax_test
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import utils as dv3_utils
from sheeprl_tpu_torch.algos.dreamer_v3.agent import actor_dists, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import Player
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import DreamerV3Agent, act, posterior_step, serve_policy_dreamer_v3
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax

from tests.test_torch_rssm_serve import SMALL
from tests.test_torch_train_loop import TINY_RUN

N_ACTIONS = 18
JAX_EPISODE = [o for o in SMALL if not o.startswith("env=")] + [
    "env=atari_dummy",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.cnn_keys.decoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "algo.mlp_keys.decoder=[]",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def jax_episode(tmp_path_factory):
    """JAX's greedy ``test`` episode, every ``get_actions`` call recorded:
    the frame, the player's state before and after, the actions."""
    cfg = compose(JAX_EPISODE)
    fabric = Fabric(devices=1, accelerator="cpu")
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    world_model, actor, _, params, player = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    steps = []
    get_actions = player.get_actions

    def recording(p, obs, key, greedy=False, mask=None):
        before = (player.actions, player.recurrent_state, player.stochastic_state)
        acts = get_actions(p, obs, key, greedy=greedy)
        steps.append({"obs": obs, "before": before, "after": (player.recurrent_state, player.stochastic_state),
                      "actions": acts})
        return acts

    player.get_actions = recording
    jax_test(player, params, fabric, cfg, str(tmp_path_factory.mktemp("jax_test")), greedy=True)
    port_cfg = dotdict({**jax_plain(cfg), "spaces": {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                                                     "actions": {"n": [N_ACTIONS], "continuous": False}}})
    state = dreamer_v3_state_from_jax(jax.tree.map(np.asarray, {"world_model": params["world_model"],
                                                                "actor": params["actor"]}))
    agent = DreamerV3Agent(*build_agent(port_cfg, "cpu", state))
    return {"world_model": world_model, "actor": actor, "params": params, "steps": steps, "agent": agent}


def test_torch_rssm_eval_greedy_episode_matches_jax_step_by_step(jax_episode):
    world_model, jactor, params = jax_episode["world_model"], jax_episode["actor"], jax_episode["params"]
    wmp, agent = params["world_model"], jax_episode["agent"]
    steps = jax_episode["steps"]
    assert len(steps) > 300  # the dummy's 3 lives
    errors = {"recurrent": 0.0, "representation": 0.0, "actor": 0.0}
    for t, step in enumerate(steps):
        obs = {k: np.asarray(v) for k, v in step["obs"].items()}
        jax_rec, jax_stoch = step["after"]
        emb = world_model.encoder.apply(wmp["encoder"], step["obs"])
        jax_logits, _ = world_model.rssm._representation(wmp, jax_rec, emb, jax.random.PRNGKey(0))
        latent = np.concatenate([np.asarray(jax_stoch), np.asarray(jax_rec)], axis=-1)
        jax_actor_logits = jax_actor_dists(jactor, jactor.apply(params["actor"], latent))[0].logits
        with torch.no_grad():
            rec, logits = posterior_step(agent, {k: torch.from_numpy(v) for k, v in obs.items()},
                                         *(_torch(a) for a in step["before"]))
            greedy = act(agent, _torch(jax_stoch), _torch(jax_rec), greedy=True)
            actor_logits = actor_dists(agent.actor, agent.actor(_torch(latent)))[0].logits
        for name, got, want in (("recurrent", rec, jax_rec), ("representation", logits, jax_logits),
                                ("actor", actor_logits, jax_actor_logits)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5, err_msg=f"{name}, step {t}")
            errors[name] = max(errors[name], float(np.abs(got.numpy() - np.asarray(want)).max()))
        np.testing.assert_array_equal(greedy[0].numpy(), np.asarray(step["actions"][0]), err_msg=f"step {t}")
    assert all(e < 1e-5 for e in errors.values()), errors


@pytest.fixture(scope="module")
def tiny():
    cfg = cli.compose_run_config(TINY_RUN)
    cfg["spaces"] = dotdict({"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                             "actions": {"n": [N_ACTIONS], "continuous": False}})
    return cfg


def _recorded_test(cfg, agent, greedy, monkeypatch):
    """``test`` with its env recording each frame it returns and each action
    it takes."""
    frames, actions = [], []
    make_env = dv3_utils.make_env

    def recording_env(*args, **kwargs):
        env = make_env(*args, **kwargs)
        reset, step = env.reset, env.step

        def rec_reset(*a, **k):
            out = reset(*a, **k)
            frames.append(out[0]["rgb"].copy())
            return out

        def rec_step(action):
            actions.append(int(action))
            out = step(action)
            frames.append(out[0]["rgb"].copy())
            return out

        env.reset, env.step = rec_reset, rec_step
        return env

    monkeypatch.setattr(dv3_utils, "make_env", recording_env)
    reward, steps = dv3_utils.test(agent, cfg, "cpu", greedy=greedy)
    monkeypatch.setattr(dv3_utils, "make_env", make_env)
    assert steps == len(actions) == len(frames) - 1
    return reward, frames[:-1], actions


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_torch_rssm_eval_served_session_replays_the_episode(tiny, mode, monkeypatch):
    policy = serve_policy_dreamer_v3(tiny, None, "cpu")
    _, frames, actions = _recorded_test(tiny, policy.params, mode == "greedy", monkeypatch)
    assert len(actions) > 300 and len(set(actions)) > 1
    with PolicyServer(policy, {"mode": mode, "max_wait_ms": 0.0, "session": {"buckets": [1, 4]}}) as server:
        served = []
        for t, frame in enumerate(frames):
            out, _ = server.client.act({"rgb": frame[None]}, session_id="episode", reset=t == 0, timeout=60)
            served.append(int(out[0, 0]))
            if t % 50 == 0:  # another session in the same dispatches changes nothing
                server.client.act({"rgb": frames[-1 - t][None]}, session_id="other", timeout=60)
    assert served == actions


def test_torch_rssm_eval_test_episode_consumes_no_generator(tiny):
    world_model, actor = build_agent(tiny, "cpu", None)
    generator = torch.Generator().manual_seed(3)
    player = Player(world_model, actor, 1, generator)
    before, global_before = generator.get_state(), torch.get_rng_state()
    first = dv3_utils.test(player.agent, tiny, "cpu", greedy=False)
    assert torch.equal(generator.get_state(), before) and torch.equal(torch.get_rng_state(), global_before)
    assert dv3_utils.test(player.agent, tiny, "cpu", greedy=False) == first  # counters: the same episode


def test_torch_rssm_eval_player_greedy_takes_the_actors_mode(tiny):
    world_model, actor = build_agent(tiny, "cpu", None)
    player = Player(world_model, actor, 2, torch.Generator().manual_seed(0))
    player.init_states()
    obs = {"rgb": torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1)) - 0.5}
    acts = player.get_actions(obs, greedy=True)
    with torch.no_grad():
        mode = act(player.agent, player.stochastic_state, player.recurrent_state, greedy=True)
    for a, m in zip(acts, mode):
        assert torch.equal(a, m)


def test_torch_rssm_eval_run_ends_in_a_test_episode(tmp_path):
    on = cli.run(TINY_RUN + [f"log_root={tmp_path}/on", "algo.total_steps=9", "checkpoint.save_last=false"])
    assert np.isfinite(on["test_reward"]) and on["test_steps"] > 300
    off = cli.run(TINY_RUN + [f"log_root={tmp_path}/off", "algo.total_steps=9", "checkpoint.save_last=false",
                              "algo.run_test=false"])
    assert off["test_reward"] is None and off["test_steps"] is None
    assert off["metrics"] == on["metrics"] and off["policy_steps"] == on["policy_steps"]
