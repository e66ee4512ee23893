"""The port's PPO agent (``sheeprl_tpu_torch/algos/ppo/agent.py``) against
the flax ``PPOAgent``, on the CPU, under weights carried across by
``ppo_state_from_jax``.

Two encoders at the JAX recipe's widths: the CartPole MLP (2 x 64 tanh,
``mlp_features_dim`` 64) and NatureCNN on 64x64x3 Atari-protocol pixels
with 18 actions; and a multi-discrete head pair. Every leaf of the flax
tree is perturbed first, so the zero-initialised biases are carried too.
Logits, values, and the log-prob and entropy of given actions agree within
atol 1e-5 (float32 on both sides, sums in another order). NatureCNN's
``fc`` reads its input flattened in (H, W, C) order, as flax flattens NHWC;
the test also flattens the same conv output in (C, H, W) order and checks
that it then does not agree, so a wrong order cannot pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.agent import forward_with_actions as jax_forward_with_actions
from sheeprl_tpu.algos.ppo.agent import sample_actions as jax_sample_actions
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent, forward_with_actions, sample_actions
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax

ATOL = 1e-5
CASES = {
    "mlp": ([], ["state"], (2,), {"state": (4,)}),
    "nature-cnn": (["rgb"], [], (18,), {"rgb": (64, 64, 3)}),
    "multi-discrete": ([], ["state"], (3, 4), {"state": (6,)}),
}


def _port_cfg(cnn_keys, mlp_keys):
    return apply_overrides(preset("ppo"), [f"algo.cnn_keys.encoder={cnn_keys}", f"algo.mlp_keys.encoder={mlp_keys}"])


def _obs(rng, shapes, batch):
    out = {}
    for k, shape in shapes.items():
        if len(shape) == 3:  # pixels as the player hands them over: x / 255 - 0.5
            out[k] = (rng.integers(0, 256, (batch, *shape)).astype(np.float32) / 255.0 - 0.5).astype(np.float32)
        else:
            out[k] = rng.normal(size=(batch, *shape)).astype(np.float32)
    return out


def _pair(case, seed=0):
    cnn_keys, mlp_keys, actions_dim, shapes = CASES[case]
    cfg = _port_cfg(cnn_keys, mlp_keys)
    jax_agent = JaxPPOAgent(
        actions_dim=actions_dim,
        is_continuous=False,
        cnn_keys=tuple(cnn_keys),
        mlp_keys=tuple(mlp_keys),
        encoder_cfg=dict(cfg.algo.encoder),
        actor_cfg=dict(cfg.algo.actor),
        critic_cfg=dict(cfg.algo.critic),
    )
    rng = np.random.default_rng(seed)
    dummy = {k: jnp.zeros((1, *s)) for k, s in shapes.items()}
    params = jax.tree.map(np.asarray, jax_agent.init(jax.random.PRNGKey(seed), dummy))
    params = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    spaces = {k: {"shape": list(s)} for k, s in shapes.items()}
    agent, _ = build_agent(cfg, actions_dim, False, spaces, "cpu", ppo_state_from_jax(params))
    return jax_agent, params, agent, shapes, actions_dim


@pytest.mark.parametrize("case", list(CASES))
def test_torch_ppo_agent_forward_matches_flax(case):
    jax_agent, params, agent, shapes, actions_dim = _pair(case)
    rng = np.random.default_rng(1)
    obs = _obs(rng, shapes, 8)
    actions = [np.eye(d, dtype=np.float32)[rng.integers(0, d, 8)] for d in actions_dim]
    want_outs, want_values = jax_agent.apply(params, {k: jnp.asarray(v) for k, v in obs.items()})
    want = jax_forward_with_actions(jax_agent, params, {k: jnp.asarray(v) for k, v in obs.items()}, [jnp.asarray(a) for a in actions])
    t_obs = {k: torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        got_outs, got_values = agent(t_obs)
        got = forward_with_actions(agent, t_obs, [torch.from_numpy(a) for a in actions])
    assert len(got_outs) == len(actions_dim)
    for g, w in zip(got_outs, want_outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got_values.numpy(), np.asarray(want_values), atol=ATOL, rtol=1e-5)
    for name, g, w in zip(("logprob", "entropy", "values"), got, want):
        assert g.shape == (8, 1), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5, err_msg=name)
    # the greedy player forward picks the same actions
    with torch.no_grad():
        g_acts, g_logprob, _ = sample_actions(agent, t_obs, greedy=True)
    w_acts, w_logprob, _ = jax_sample_actions(jax_agent, params, {k: jnp.asarray(v) for k, v in obs.items()},
                                              jax.random.PRNGKey(0), greedy=True)
    for g, w in zip(g_acts, w_acts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(g_logprob.numpy(), np.asarray(w_logprob), atol=ATOL, rtol=1e-5)


def test_torch_ppo_agent_nature_cnn_flatten_order_is_flax_s():
    jax_agent, params, agent, shapes, _ = _pair("nature-cnn", seed=2)
    obs = _obs(np.random.default_rng(3), shapes, 4)
    want = np.asarray(jax_agent.apply(params, {k: jnp.asarray(v) for k, v in obs.items()})[1])
    nature = agent.feature_extractor.cnn_encoder.nature
    with torch.no_grad():
        conv = nature.cnn(torch.from_numpy(obs["rgb"]))  # (B, 4, 4, 64), NHWC
        for order, close in (((0, 1, 2, 3), True), ((0, 3, 1, 2), False)):  # (H, W, C), then (C, H, W)
            feat = torch.relu(nature.fc(conv.permute(*order).reshape(4, -1)))
            values = agent.critic(feat).numpy()
            assert np.allclose(values, want, atol=ATOL, rtol=1e-5) == close, order


def test_torch_ppo_agent_initialises_as_flax_from_the_seed():
    """lecun_normal kernels (truncated normal, variance 1 / fan_in) and zero
    biases, drawn from the seed: one seed gives one agent, another a
    different one."""
    cfg = _port_cfg(["rgb"], ["state"])
    spaces = {"rgb": {"shape": [64, 64, 3]}, "state": {"shape": [4]}}
    a, _ = build_agent(cfg, (18,), False, spaces)
    b, _ = build_agent(cfg, (18,), False, spaces)
    c, _ = build_agent(apply_overrides(cfg, ["seed=7"]), (18,), False, spaces)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.critic.dense_0.weight, c.critic.dense_0.weight)
    for name, p in a.state_dict().items():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
        else:
            fan_in = p.shape[1] * int(np.prod(p.shape[2:]))
            std = float(np.sqrt(1.0 / fan_in))
            assert float(p.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, name
            if p.numel() >= 1000:
                assert abs(float(p.std()) - std) < 0.1 * std, name


def test_torch_ppo_agent_state_dict_takes_the_whole_flax_tree():
    for case in CASES:
        _, params, agent, _, _ = _pair(case)
        converted = ppo_state_from_jax(params)
        assert set(converted) == set(agent.state_dict()), case
        n_flax = len(jax.tree_util.tree_leaves(params))
        assert len(converted) == n_flax, case


def test_torch_ppo_agent_rejects_a_continuous_action_space():
    """A continuous space no longer raises: it gets flax's one head of
    width 2 * sum(actions_dim), the mean and the log std (the head's parity
    is in tests/test_torch_ppo_continuous.py); what it rejects is a noise
    tensor of another shape than the mean's."""
    cfg = _port_cfg([], ["state"])
    agent = PPOAgent((2,), True, [], ["state"], cfg.algo.encoder, cfg.algo.actor, cfg.algo.critic, {"state": (4,)})
    assert agent.is_continuous and agent.n_heads == 1 and agent.actor_head_0.out_features == 4
    assert not hasattr(agent, "actor_head_1")
    with pytest.raises(ValueError, match="noise"):
        sample_actions(agent, {"state": torch.zeros(3, 4)}, noise=torch.zeros(3, 4))
