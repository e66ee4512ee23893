"""Continuous PPO in the port against the JAX package, on the CPU:

- ``distributions.Normal`` (with ``Independent``): log-prob, entropy and
  mode against JAX's ``Normal`` within rtol 1e-6 (the same formulas in the
  same op order);
- the continuous head (``actor_head_0`` of width 2 * sum(actions_dim), the
  mean and the log std of an ``Independent(Normal)``) against the flax
  ``PPOAgent`` under weights carried by ``ppo_state_from_jax``: the head's
  output, values, log-prob and entropy of given actions within atol 1e-5;
  sampled actions fed JAX's own normals (``jax.random.normal`` of the key)
  and greedy actions (the mean) within atol 1e-5;
- one full PPO update (4 envs x 16 steps, 2 epochs, minibatches of 8) with
  JAX's own permutations, losses within rtol 1e-5 and every parameter
  within atol 1e-5, as ``tests/test_torch_ppo_update.py`` holds the
  discrete update;
- stateless serving of a continuous checkpoint against JAX's
  ``serve_policy_ppo`` (greedy, and sampled on JAX's normals, within atol
  1e-5); a sampled batched row draws the row alone's normals exactly and
  its action within atol 1e-6 (a matmul over another batch size may round
  its last bit otherwise);
- ``run preset=ppo env.id=Pendulum-v1``: the raw, unclipped sampled actions
  reach the env (Pendulum clips the torque inside ``step``, as gymnasium's
  does), a checkpoint resumes, and ``evaluation`` repeats the run's test
  episode; the same on ``continuous_dummy``.
"""

import math

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.agent import forward_with_actions as jax_forward_with_actions
from sheeprl_tpu.algos.ppo.agent import sample_actions as jax_sample_actions
from sheeprl_tpu.algos.ppo.evaluate import serve_policy_ppo as jax_serve_policy_ppo
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.distributions import Independent as JaxIndependent
from sheeprl_tpu.distributions import Normal as JaxNormal
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, forward_with_actions, sample_actions
from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.distributions import Independent, Normal
from sheeprl_tpu_torch.envs import vector as vector_module
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax

from tests.test_torch_ppo_update import jax_permutations

ATOL = 1e-5
HEADS = {"pendulum": (3, (1,)), "continuous-dummy": (10, (2,))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(5,), (4, 3), (2, 3, 2)])
def test_torch_ppo_continuous_normal_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    loc = rng.normal(size=shape).astype(np.float32)
    scale = np.exp(rng.normal(size=shape)).astype(np.float32)
    value = (loc + scale * rng.normal(size=shape) * 2).astype(np.float32)
    jd, pd = JaxNormal(jnp.asarray(loc), jnp.asarray(scale)), Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    np.testing.assert_allclose(pd.log_prob(torch.from_numpy(value)).numpy(), np.asarray(jd.log_prob(value)), rtol=1e-6)
    np.testing.assert_allclose(pd.entropy().numpy(), np.asarray(jd.entropy()), rtol=1e-6)
    np.testing.assert_array_equal(pd.mode.numpy(), np.asarray(jd.mode))
    ji, pi = JaxIndependent(jd, 1), Independent(pd, 1)
    np.testing.assert_allclose(pi.log_prob(torch.from_numpy(value)).numpy(), np.asarray(ji.log_prob(value)), rtol=1e-6)
    np.testing.assert_allclose(pi.entropy().numpy(), np.asarray(ji.entropy()), rtol=1e-6)
    noise = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(pi.sample(noise=torch.from_numpy(noise)).numpy(), loc + scale * noise, rtol=1e-6)
    # the entropy does not depend on loc, the log-prob at the mean is the entropy's peak term
    np.testing.assert_allclose(pd.log_prob(pd.mean).numpy(), -np.log(scale) - 0.5 * math.log(2 * math.pi), rtol=1e-6)


def _pair(case, seed=0):
    obs_dim, dims = HEADS[case]
    cfg = preset("ppo")
    jax_agent = JaxPPOAgent(actions_dim=dims, is_continuous=True, cnn_keys=(), mlp_keys=("state",),
                            encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                            critic_cfg=dict(cfg.algo.critic))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jax_agent.init(jax.random.PRNGKey(seed), {"state": jnp.zeros((1, obs_dim))}))
    params = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    agent, _ = build_agent(cfg, dims, True, {"state": {"shape": [obs_dim]}}, "cpu", ppo_state_from_jax(params))
    return jax_agent, params, agent, obs_dim, dims


@pytest.mark.parametrize("case", list(HEADS))
def test_torch_ppo_continuous_head_matches_flax(case):
    jax_agent, params, agent, obs_dim, dims = _pair(case)
    assert agent.actor_head_0.out_features == 2 * sum(dims)
    assert set(ppo_state_from_jax(params)) == set(agent.state_dict())
    rng = np.random.default_rng(1)
    n = 32
    obs = {"state": rng.normal(size=(n, obs_dim)).astype(np.float32)}
    t_obs = {"state": torch.from_numpy(obs["state"])}
    actions = rng.normal(size=(n, sum(dims))).astype(np.float32)
    with torch.no_grad():
        outs, values = agent(t_obs)
        logprob, entropy, v2 = forward_with_actions(agent, t_obs, [torch.from_numpy(actions)])
    j_outs, j_values = jax_agent.apply(params, obs)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(j_outs[0]), atol=ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(j_values), atol=ATOL)
    w_logprob, w_entropy, _ = jax_forward_with_actions(jax_agent, params, obs, [jnp.asarray(actions)])
    np.testing.assert_allclose(logprob.numpy(), np.asarray(w_logprob), atol=ATOL)
    np.testing.assert_allclose(entropy.numpy(), np.asarray(w_entropy), atol=ATOL)
    assert logprob.shape == entropy.shape == v2.shape == (n, 1)
    for seed in range(3):  # JAX's own normals, drawn from the key it samples with
        key = jax.random.PRNGKey(seed)
        noise = np.array(jax.random.normal(key, (n, sum(dims))))
        with torch.no_grad():
            acts, lp, _ = sample_actions(agent, t_obs, noise=torch.from_numpy(noise))
        w_acts, w_lp, _ = jax_sample_actions(jax_agent, params, obs, key)
        np.testing.assert_allclose(acts[0].numpy(), np.asarray(w_acts[0]), atol=ATOL)
        np.testing.assert_allclose(lp.numpy(), np.asarray(w_lp), atol=ATOL)
    with torch.no_grad():
        greedy, lp, _ = sample_actions(agent, t_obs, greedy=True)
    w_greedy, w_lp, _ = jax_sample_actions(jax_agent, params, obs, jax.random.PRNGKey(0), greedy=True)
    np.testing.assert_allclose(greedy[0].numpy(), np.asarray(w_greedy[0]), atol=ATOL)
    np.testing.assert_allclose(greedy[0].numpy(), outs[0][:, : sum(dims)].numpy())  # the mean half
    np.testing.assert_allclose(lp.numpy(), np.asarray(w_lp), atol=ATOL)


N_ENVS, T, EPOCHS = 4, 16, 2
ROWS = N_ENVS * T


@pytest.fixture(scope="module")
def update():
    overrides = [f"env.num_envs={N_ENVS}", f"algo.rollout_steps={T}", "algo.per_rank_batch_size=8",
                 f"algo.update_epochs={EPOCHS}", "algo.normalize_advantages=True", "algo.clip_vloss=True"]
    cfg = compose(["exp=ppo", "env.id=Pendulum-v1"] + overrides)
    port_cfg = apply_overrides(preset("ppo"), overrides)
    jax_agent = JaxPPOAgent(actions_dim=(1,), is_continuous=True, cnn_keys=(), mlp_keys=("state",),
                            encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                            critic_cfg=dict(cfg.algo.critic))
    params = jax_agent.init(jax.random.PRNGKey(2), {"state": jnp.zeros((1, 3), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = optax.inject_hyperparams(lambda learning_rate: jax_build_optimizer(
        {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm))(
        learning_rate=float(cfg.algo.optimizer.lr))
    train = jax_make_train_step(jax_agent, tx, cfg, Fabric(devices=1, accelerator="cpu").mesh, ROWS, donate=False,
                                guard=False)
    rng = np.random.default_rng(4)
    data = {
        "state": rng.normal(size=(ROWS, 3)).astype(np.float32),
        "actions": (rng.normal(size=(ROWS, 1)) * 1.5).astype(np.float32),
        "logprobs": (-1.4 + 0.3 * rng.normal(size=(ROWS, 1))).astype(np.float32),
        "values": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "returns": (rng.normal(size=(ROWS, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "rewards": -np.ones((ROWS, 1), np.float32),
        "dones": np.zeros((ROWS, 1), np.uint8),
    }
    key = jax.random.PRNGKey(6)
    new_params, _, pg, v, ent = train(params, tx.init(params), data, key, jnp.float32(0.2), jnp.float32(0.01))
    agent, _ = build_agent(port_cfg, (1,), True, {"state": {"shape": [3]}}, "cpu", ppo_state_from_jax(before))
    losses, _ = make_train_step(agent, make_optimizer(port_cfg, agent), port_cfg, ROWS)(
        {k: torch.from_numpy(np.array(a)) for k, a in data.items()}, 0.2, 0.01,
        perms=torch.from_numpy(jax_permutations(key, EPOCHS, ROWS)))
    return {"jax": ([float(pg), float(v), float(ent)], ppo_state_from_jax(jax.tree.map(np.asarray, new_params))),
            "port": (losses.tolist(), {k: t.detach().clone() for k, t in agent.state_dict().items()}),
            "before": ppo_state_from_jax(before)}


def test_torch_ppo_continuous_update_losses_match_jax(update):
    np.testing.assert_allclose(update["port"][0], update["jax"][0], rtol=1e-5, atol=1e-7)


def test_torch_ppo_continuous_update_parameters_match_jax(update):
    got, want = update["port"][1], update["jax"][1]
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=name)
        assert not np.array_equal(value.numpy(), update["before"][name].numpy()), name


def test_torch_ppo_continuous_serving_matches_jax():
    cfg = compose(["exp=ppo", "env=gym", "env.id=Pendulum-v1", "env.capture_video=False", "fabric.devices=1",
                   "metric.log_level=0", "algo.mlp_keys.encoder=[state]"])
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    jax_policy = jax_serve_policy_ppo(Fabric(devices=1, accelerator="cpu"), cfg, obs_space,
                                      gym.spaces.Box(-2.0, 2.0, (1,), np.float32), None)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
                          jax_policy.params)
    port_cfg = preset("ppo")
    port_cfg["spaces"] = {"obs": {"state": {"shape": [3], "dtype": "float32"}},
                          "actions": {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True}}
    port = serve_policy_ppo(apply_overrides(port_cfg, []), {"agent": ppo_state_from_jax(params)}, "cpu")
    assert port.action_dim == jax_policy.action_dim == 1 and port.obs_spec == jax_policy.obs_spec
    n = 48
    raw = {"state": (rng.normal(size=(n, 3)) * 2).astype(np.float32)}
    jax_obs, port_obs = jax_policy.prepare(raw, n), port.prepare(raw, n)
    t_obs = {k: torch.from_numpy(v) for k, v in port_obs.items()}
    with torch.no_grad():
        greedy = port.greedy_fn(port.params, t_obs).numpy()
    np.testing.assert_allclose(greedy, np.asarray(jax_policy.greedy_fn(params, jax_obs)), atol=ATOL)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (n, 1))))
        with torch.no_grad():
            sampled = port.sample_fn(port.params, t_obs, noise).numpy()
        np.testing.assert_allclose(sampled, np.asarray(jax_policy.sample_fn(params, jax_obs, key)), atol=ATOL)
    seeds, counters = torch.full((n,), 11, dtype=torch.int64), torch.arange(n, dtype=torch.int64)
    draws = port.draw_fn(seeds, counters)
    with torch.no_grad():
        batch = port.sample_fn(port.params, t_obs, draws)
        for i in (0, 17, n - 1):
            own = port.draw_fn(seeds[i:i + 1], counters[i:i + 1])
            torch.testing.assert_close(draws[i:i + 1], own, rtol=0, atol=0)
            alone = port.sample_fn(port.params, {k: v[i:i + 1] for k, v in t_obs.items()}, own)
            torch.testing.assert_close(batch[i:i + 1], alone, rtol=0, atol=1e-6)
    assert not np.allclose(batch.numpy(), greedy)


SMALL = ["preset=ppo", "env.id=Pendulum-v1", "fabric.accelerator=cpu", "metric.log_level=0", "algo.rollout_steps=64",
         "buffer.size=64", "algo.per_rank_batch_size=64", "algo.update_epochs=2"]


def test_torch_ppo_continuous_run_sends_raw_actions_and_resumes(tmp_path, monkeypatch):
    sent = []
    step = vector_module.SyncVectorEnv.step

    def recording(self, actions):
        sent.append(np.array(actions))
        return step(self, actions)

    monkeypatch.setattr(vector_module.SyncVectorEnv, "step", recording)
    K.reset_launches()
    first = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=512"])
    assert first["iterations"] == 2 and first["policy_steps"] == 512 and K.LAUNCHES["gae"] == 0
    assert np.isfinite(np.asarray(first["losses"])).all()
    actions = np.concatenate(sent[:128])
    assert actions.shape == (512, 1) and actions.dtype == np.float32
    assert np.abs(actions).max() > 2.0  # unclipped: Pendulum clips the torque itself
    assert all(ep_len == 200 for _, _, _, ep_len in first["episodes"])  # truncated at 200, never terminated
    state = load_checkpoint(first["checkpoint"])
    assert state["agent"]["actor_head_0.weight"].shape == (2, 64)
    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", f"log_root={tmp_path}", "algo.total_steps=768"])
    assert resumed["start_iter"] == 3 and resumed["iterations"] == 1 and resumed["policy_steps"] == 768
    evaluated = cli.evaluation([f"checkpoint_path={resumed['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["steps"] == 200 and evaluated["reward"] == resumed["test_reward"]


def test_torch_ppo_continuous_run_on_the_counter_env(tmp_path):
    out = cli.run(["preset=ppo", "env.id=continuous_dummy", "fabric.accelerator=cpu", "metric.log_level=0",
                   "algo.rollout_steps=8", "buffer.size=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1",
                   "algo.total_steps=64", f"log_root={tmp_path}"])
    assert out["iterations"] == 2 and np.isfinite(np.asarray(out["losses"])).all()
    assert out["test_steps"] == 129  # the counter env ends on the step after its 128th
