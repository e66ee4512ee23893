"""The port's recurrent PPO agent (``sheeprl_tpu_torch/algos/ppo_recurrent/agent.py``)
against the flax ``RecurrentPPOAgent`` on the CPU, under weights carried
across by ``ppo_recurrent_state_from_jax`` (every flax leaf perturbed
first, so the zero biases are carried too).

Over a T=16 sequence from a random ``(hx, cx)``: the actor outputs, values
and the final LSTM pair within atol 1e-5 (float32 on both sides: torch's
LSTM sums its gate products in another order than XLA's scan); the
log-prob and entropy of given actions within atol 2e-5 and rtol 2e-6 (the
continuous log-prob of a random action reaches ~60 in magnitude). Cases: the recipe (CartPole, LSTM 64,
LayerNorm MLPs), the pre- and post-LSTM MLPs on, a multi-discrete head
pair, a continuous head, and pixels with a vector key (NatureCNN). Sampled
actions fed JAX's own draws (its per-head key split and uniforms, or its
normals) equal JAX's; greedy ones equal too. The LSTM's held-zero input
bias stays out of training, and the seeded init is flax's: orthogonal
recurrent kernels, zero biases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent.agent import RecurrentPPOAgent as JaxAgent
from sheeprl_tpu.algos.ppo_recurrent.agent import forward_with_actions as jax_forward_with_actions
from sheeprl_tpu.algos.ppo_recurrent.agent import sample_actions as jax_sample_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, forward_with_actions, sample_actions
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_recurrent_state_from_jax

ATOL = 1e-5
T, B, H = 16, 5, 64
_TINY = float(np.finfo(np.float32).tiny)
CASES = {
    "recipe": ([], ["state"], (2,), False, {"state": (4,)}, []),
    "pre-post-mlp": ([], ["state"], (2,), False, {"state": (4,)},
                     ["algo.rnn.pre_rnn_mlp.apply=true", "algo.rnn.post_rnn_mlp.apply=true"]),
    "multi-discrete": ([], ["state"], (2, 3), False, {"state": (10,)}, []),
    "continuous": ([], ["state"], (2,), True, {"state": (10,)}, []),
    "pixels": (["rgb"], ["state"], (2,), False, {"rgb": (64, 64, 3), "state": (10,)}, []),
}


def cfg_for(case):
    cnn_keys, mlp_keys, _, _, _, extra = CASES[case]
    return apply_overrides(preset("ppo_recurrent"),
                           [f"algo.cnn_keys.encoder={cnn_keys}", f"algo.mlp_keys.encoder={mlp_keys}"] + extra)


def pair(case, seed=0):
    """The flax agent, its perturbed params, and the port's agent on them."""
    cnn_keys, mlp_keys, dims, continuous, shapes, _ = CASES[case]
    cfg = cfg_for(case)
    jax_agent = JaxAgent(actions_dim=dims, is_continuous=continuous, cnn_keys=tuple(cnn_keys), mlp_keys=tuple(mlp_keys),
                         encoder_cfg=dict(cfg.algo.encoder), rnn_cfg=dict(cfg.algo.rnn),
                         actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic))
    dummy = {k: jnp.zeros((1, 1, *s)) for k, s in shapes.items()}
    z = jnp.zeros((1, H))
    params = jax_agent.init(jax.random.PRNGKey(seed), dummy, jnp.zeros((1, 1, sum(dims))), z, z)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    spaces = {k: {"shape": list(s)} for k, s in shapes.items()}
    agent, _ = build_agent(cfg, dims, continuous, spaces, "cpu", ppo_recurrent_state_from_jax(params))
    return jax_agent, params, agent


def inputs(case, rng, t=T, b=B):
    cnn_keys, _, dims, continuous, shapes, _ = CASES[case]
    obs = {}
    for k, s in shapes.items():
        if k in cnn_keys:
            obs[k] = (rng.integers(0, 256, (t, b, *s)).astype(np.float32) / 255.0 - 0.5).astype(np.float32)
        else:
            obs[k] = rng.normal(size=(t, b, *s)).astype(np.float32)
    prev = rng.normal(size=(t, b, sum(dims))).astype(np.float32)
    hx, cx = (rng.normal(size=(b, H)).astype(np.float32) * 0.5 for _ in range(2))
    if continuous:
        actions = [rng.normal(size=(t, b, sum(dims))).astype(np.float32)]
    else:
        actions = [np.eye(d, dtype=np.float32)[rng.integers(0, d, (t, b))] for d in dims]
    return obs, prev, hx, cx, actions


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_ppo_recurrent_agent_forward_over_t_matches_flax(case):
    jax_agent, params, agent = pair(case)
    obs, prev, hx, cx, actions = inputs(case, np.random.default_rng(1), t=4 if case == "pixels" else T)
    with torch.no_grad():
        outs, values, (h, c) = agent(_t(obs), torch.from_numpy(prev), torch.from_numpy(hx), torch.from_numpy(cx))
        logprob, entropy, _ = forward_with_actions(agent, _t(obs), torch.from_numpy(prev), torch.from_numpy(hx),
                                                   torch.from_numpy(cx), [torch.from_numpy(a) for a in actions])
    j_outs, j_values, (j_h, j_c) = jax_agent.apply(params, obs, prev, hx, cx)
    for got, want in zip(outs, j_outs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(j_values), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(j_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(j_c), atol=ATOL)
    w_logprob, w_entropy, _ = jax_forward_with_actions(jax_agent, params, obs, prev, hx, cx, actions)
    np.testing.assert_allclose(logprob.numpy(), np.asarray(w_logprob), atol=2 * ATOL, rtol=2e-6)
    np.testing.assert_allclose(entropy.numpy(), np.asarray(w_entropy), atol=2 * ATOL, rtol=2e-6)


@pytest.mark.parametrize("case", ["recipe", "multi-discrete", "continuous"])
def test_torch_ppo_recurrent_agent_samples_like_flax_on_its_draws(case):
    jax_agent, params, agent = pair(case)
    _, _, dims, continuous, _, _ = CASES[case]
    rng = np.random.default_rng(2)
    obs, prev, hx, cx, _ = inputs(case, rng, t=1)
    t_args = (_t(obs), torch.from_numpy(prev), torch.from_numpy(hx), torch.from_numpy(cx))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        w_acts, w_lp, w_v, (w_h, w_c) = jax_sample_actions(jax_agent, params, obs, prev, hx, cx, key)
        with torch.no_grad():
            if continuous:
                noise = torch.from_numpy(np.array(jax.random.normal(key, (1, B, sum(dims)))))
                acts, lp, v, (h, c) = sample_actions(agent, *t_args, noise=noise)
                np.testing.assert_allclose(acts[0].numpy(), np.asarray(w_acts[0]), atol=ATOL)
            else:
                uniforms = [torch.from_numpy(np.array(jax.random.uniform(k, (1, B, d), minval=_TINY, maxval=1.0)))
                            for k, d in zip(jax.random.split(key, len(dims)), dims)]
                acts, lp, v, (h, c) = sample_actions(agent, *t_args, uniforms=uniforms)
                for a, w in zip(acts, w_acts):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        np.testing.assert_allclose(lp.numpy(), np.asarray(w_lp), atol=2 * ATOL, rtol=2e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(w_v), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(w_h), atol=ATOL)
    with torch.no_grad():
        greedy = sample_actions(agent, *t_args, greedy=True)[0]
    w_greedy = jax_sample_actions(jax_agent, params, obs, prev, hx, cx, jax.random.PRNGKey(0), greedy=True)[0]
    for a, w in zip(greedy, w_greedy):
        if continuous:
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["recipe", "pre-post-mlp"])
def test_torch_ppo_recurrent_agent_state_dict_takes_the_whole_flax_tree(case):
    _, params, agent = pair(case)
    converted = ppo_recurrent_state_from_jax(params)
    assert set(converted) == set(agent.state_dict())
    lstm = params["params"]["rnn"]["lstm"]
    np.testing.assert_array_equal(converted["rnn.lstm.weight_ih_l0"][H:2 * H].numpy(), lstm["if"]["kernel"].T)
    np.testing.assert_array_equal(converted["rnn.lstm.weight_hh_l0"][3 * H:].numpy(), lstm["ho"]["kernel"].T)
    np.testing.assert_array_equal(converted["rnn.lstm.bias_hh_l0"][2 * H:3 * H].numpy(), lstm["hg"]["bias"])
    assert not converted["rnn.lstm.bias_ih_l0"].any()
    n_flax = len(jax.tree_util.tree_leaves(params))
    n_lstm_flax = len(jax.tree_util.tree_leaves(lstm))  # 8 kernels, 4 biases -> 4 tensors
    assert len(converted) == n_flax - n_lstm_flax + 4


def test_torch_ppo_recurrent_agent_trains_what_flax_trains_and_inits_as_flax():
    cfg = cfg_for("recipe")
    agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu")
    trainable = {id(p) for p in agent.trainable_parameters()}
    named = dict(agent.named_parameters())
    assert id(named["rnn.lstm.bias_ih_l0"]) not in trainable and len(trainable) == len(named) - 1
    assert not named["rnn.lstm.bias_ih_l0"].any() and not named["rnn.lstm.bias_hh_l0"].any()
    w_hh = named["rnn.lstm.weight_hh_l0"].detach()
    for g in range(4):
        block = w_hh[g * H:(g + 1) * H]
        torch.testing.assert_close(block @ block.T, torch.eye(H), atol=1e-5, rtol=0)
    w_ih = named["rnn.lstm.weight_ih_l0"].detach()
    assert w_ih.abs().max() <= 2 * np.sqrt(1.0 / w_ih.shape[1]) / 0.87962566103423978 + 1e-6  # truncated at 2 std
    again, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu")
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, agent.state_dict()[k], rtol=0, atol=0)  # one seed, one init
