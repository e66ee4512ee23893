"""The port's SAC agent (``sheeprl_tpu_torch/algos/sac/agent.py``) against
the JAX package's flax agent, on the CPU.

Both sides hold the same weights: the flax tree built by the JAX
``build_agent`` (hidden 32, 2 critics, Pendulum's 3 observations and a
torque in [-2, 2]; also 3 critics and a 2-D action box) crosses with
``sac_state_from_jax``. Observations, actions and the Gaussian noise are
numpy from a seed; the noise is JAX's own ``normal`` draw, fed to the
port's sampling functions. Tolerances: float32 matmuls summed in another
order, so atol 1e-5 on Q values, actions, TD targets and the EMA; the
log-probs within atol 1e-4: ``log(scale * (1 - tanh(x)^2) + 1e-6)`` cancels
near a saturated action, where one ulp of ``tanh`` (XLA's and torch's
differ by that) moves ``1 - y^2 ~ 1e-3`` by ~1e-4 relative.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.agent import squashed_gaussian_sample as jax_squashed
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.sac.agent import build_agent, squashed_gaussian_sample
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
LOGP_TOL = dict(atol=1e-4, rtol=1e-5)
CASES = {
    "pendulum": dict(obs=3, low=[-2.0], high=[2.0], n=2),
    "box2-n3": dict(obs=5, low=[-1.0, 0.0], high=[1.0, 3.0], n=3),
}


@pytest.fixture(scope="module", params=list(CASES))
def agents(request):
    c = CASES[request.param]
    over = ["algo.hidden_size=32", f"algo.critic.n={c['n']}"]
    cfg = compose(["exp=sac"] + over)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (c["obs"],), np.float32)})
    act_space = gym.spaces.Box(np.array(c["low"], np.float32), np.array(c["high"], np.float32))
    jagent, params, _ = jax_build_agent(Fabric(devices=1, accelerator="cpu"), cfg, obs_space, act_space)
    port_cfg = apply_overrides(preset("sac"), over + ["algo.actor.hidden_size=32", "algo.critic.hidden_size=32"])
    space = {"shape": [len(c["low"])], "low": c["low"], "high": c["high"]}
    agent, player = build_agent(port_cfg, c["obs"], space, "cpu", sac_state_from_jax(jax.tree.map(np.asarray, params)),
                                torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(16, c["obs"])).astype(np.float32)
    act = rng.uniform(c["low"], c["high"], size=(16, len(c["low"]))).astype(np.float32)
    return jagent, params, agent, player, obs, act


def test_torch_sac_agent_state_has_the_flax_tree_and_its_shapes(agents):
    jagent, params, agent, _, _, _ = agents
    assert set(agent.state_dict()) == set(sac_state_from_jax(jax.tree.map(np.asarray, params)))
    assert agent.critic.qfs["model"].dense_0.kernel.shape == params["critic"]["params"]["qfs"]["model"]["dense_0"]["kernel"].shape
    assert agent.target_entropy == jagent.target_entropy and agent.tau == jagent.tau
    np.testing.assert_allclose(agent.action_scale.numpy(), jagent.action_scale)
    np.testing.assert_allclose(agent.action_bias.numpy(), jagent.action_bias)


def test_torch_sac_agent_forward_matches_flax(agents):
    jagent, params, agent, _, obs, act = agents
    o, a = torch.from_numpy(obs), torch.from_numpy(act)
    with torch.no_grad():
        q = agent.q_values(o, a)
        assert q.shape == (16, agent.critic.n)
        np.testing.assert_allclose(q.numpy(), np.asarray(jagent.q_values(params["critic"], obs, act)), **TOL)
        mean, std = agent.actor_dist(o)
        j_mean, j_std = jagent.actor_dist(params["actor"], obs)
        np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), **TOL)
        np.testing.assert_allclose(std.numpy(), np.asarray(j_std), **TOL)
        np.testing.assert_allclose(agent.greedy_action(o).numpy(), np.asarray(jagent.greedy_action(params["actor"], obs)), **TOL)


def test_torch_sac_agent_sampling_and_td_target_match_flax(agents):
    jagent, params, agent, _, obs, act = agents
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (16, act.shape[1])))
    j_act, j_logp = jagent.sample_action(params["actor"], obs, key)
    with torch.no_grad():
        p_act, p_logp = agent.sample_action(torch.from_numpy(obs), torch.from_numpy(noise))
    np.testing.assert_allclose(p_act.numpy(), np.asarray(j_act), **TOL)
    np.testing.assert_allclose(p_logp.numpy(), np.asarray(j_logp), **LOGP_TOL)
    assert p_logp.shape == (16, 1)

    rng = np.random.default_rng(4)
    rewards = rng.normal(size=(16, 1)).astype(np.float32)
    terminated = (rng.uniform(size=(16, 1)) < 0.3).astype(np.float32)
    want = jagent.next_target_q(params, obs, rewards, terminated, 0.99, key)
    got = agent.next_target_q(*(torch.from_numpy(x) for x in (obs, rewards, terminated)), 0.99, torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGP_TOL)  # carries alpha * log-prob


def test_torch_sac_agent_squashed_sample_matches_flax():
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(32, 2)).astype(np.float32)
    std = rng.uniform(0.01, 1.5, size=(32, 2)).astype(np.float32)
    scale, bias = np.array([2.0, 0.5], np.float32), np.array([0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(9)
    j_noise = np.asarray(jax.random.normal(key, (32, 2)))
    want = jax_squashed(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(scale), jnp.asarray(bias), key)
    got = squashed_gaussian_sample(*(torch.from_numpy(x) for x in (mean, std, scale, bias, j_noise)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **LOGP_TOL)


def test_torch_sac_agent_ema_matches_flax(agents):
    jagent, params, agent, _, _, _ = agents
    moved = jax.tree.map(lambda p: p + 0.25, params["critic"])
    target = jagent.ema(moved, params["target_critic"], jnp.float32(1.0))
    with torch.no_grad():
        for p in agent.critic.parameters():
            p.add_(0.25)
    agent.ema()
    want = sac_state_from_jax({**jax.tree.map(np.asarray, params), "target_critic": jax.tree.map(np.asarray, target)})
    for k, v in agent.state_dict().items():
        if k.startswith("target_critic."):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
    assert not any(p.requires_grad for p in agent.target_critic.parameters())


def test_torch_sac_agent_player_samples_in_bounds_and_acts_greedily(agents):
    _, _, agent, player, obs, _ = agents
    o = torch.from_numpy(obs)
    a1, a2 = player(o), player(o)
    assert a1.shape == (16, agent.action_dim) and not torch.equal(a1, a2)
    low, high = agent.action_bias - agent.action_scale, agent.action_bias + agent.action_scale
    assert bool(((a1 >= low) & (a1 <= high)).all())
    assert torch.equal(player.get_actions(o, greedy=True), player.get_actions(o, greedy=True))


def test_torch_sac_agent_init_is_flax_like_and_seeded():
    cfg = apply_overrides(preset("sac"), ["algo.actor.hidden_size=64", "algo.critic.hidden_size=64", "seed=3"])
    space = {"shape": [1], "low": [-2.0], "high": [2.0]}
    a, _ = build_agent(cfg, 3, space)
    b, _ = build_agent(cfg, 3, space)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    kernel = a.critic.qfs["model"].dense_1.kernel.detach()
    assert torch.equal(a.target_critic.qfs["model"].dense_1.kernel, kernel)
    assert not torch.equal(kernel[0], kernel[1])  # each critic drawn on its own
    assert abs(float(kernel.std()) - (1.0 / 64) ** 0.5) < 0.01 and float(kernel.abs().max()) <= 2 * (1.0 / 64) ** 0.5 / 0.8796 + 1e-6
    assert float(a.log_alpha.detach()) == 0.0 and float(a.critic.qfs["model"].out.bias.abs().max()) == 0.0
