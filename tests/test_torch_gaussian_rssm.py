"""Dreamer V1's modules in the port against the JAX package's, on the CPU:

- the flax-form ``GRUCell`` against ``flax.linen.GRUCell`` on weights
  carried across by the converter, and against ``torch.nn.GRUCell`` whose
  r and z hidden biases are zero; those biases read as zeros and stay so
  through an optimizer step, while the n gate's moves;
- ``compute_stochastic_state`` (softplus std plus ``min_std``, the
  reparameterised draw), the RSSM's ``dynamic`` step (no ``is_first``) and
  ``imagination`` step on JAX's own normals, the encoder and the decoder;
- the reconstruction loss (the plain Gaussian KL with free nats, with and
  without the continue head) and the Normal KL within 1e-6;
- the converted tree loads strictly into the world model, actor and critic.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.algos.dreamer_v1 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v1.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v1.agent import compute_stochastic_state as jax_stochastic_state
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.algos.dreamer_v1 import loss as torch_loss
from sheeprl_tpu_torch.algos.dreamer_v1.agent import GRUCell, build_agent, compute_stochastic_state
from sheeprl_tpu_torch.utils.convert import _gru_state, dreamer_v1_state_from_jax
from tests.test_torch_rssm_v1_step import N_ACT, REC, STOCH, WIDTH, configs

IN, HID, ROWS = 7, 12, 5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def flax_cell():
    cell = fnn.GRUCell(features=HID)
    rng = np.random.default_rng(0)
    h, x = rng.normal(size=(ROWS, HID)).astype(np.float32), rng.normal(size=(ROWS, IN)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    # flax initialises the biases to zero: give them values so the test sees them
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.3 * jax.random.normal(jax.random.PRNGKey(len(str(p))), v.shape)
        if p[-1].key == "bias" else v, params)
    return cell, params, h, x


def _port_cell(params) -> GRUCell:
    cell = GRUCell(IN, HID)
    cell.load_state_dict(_gru_state(jax.tree.map(np.asarray, params["params"]), ""))
    return cell


def test_torch_gaussian_rssm_gru_cell_matches_flax(flax_cell):
    cell, params, h, x = flax_cell
    want, _ = cell.apply(params, jnp.asarray(h), jnp.asarray(x))
    got = _port_cell(params)(_t(h), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert set(params["params"]) == {"ir", "iz", "in", "hr", "hz", "hn"}
    assert "bias" not in params["params"]["hr"] and "bias" not in params["params"]["hz"]


def test_torch_gaussian_rssm_gru_cell_is_torch_gru_with_zero_rz_hidden_biases(flax_cell):
    _, params, h, x = flax_cell
    cell = _port_cell(params)
    ref = torch.nn.GRUCell(IN, HID)
    with torch.no_grad():
        ref.weight_ih.copy_(cell.weight_ih)
        ref.weight_hh.copy_(cell.weight_hh)
        ref.bias_ih.copy_(cell.bias_ih)
        ref.bias_hh.copy_(cell.bias_hh)
    assert torch.equal(cell.bias_hh[:2 * HID], torch.zeros(2 * HID))
    torch.testing.assert_close(cell(_t(h), _t(x)), ref(_t(x), _t(h)), rtol=1e-6, atol=1e-6)


def test_torch_gaussian_rssm_rz_hidden_biases_stay_zero_through_training(flax_cell):
    _, params, h, x = flax_cell
    cell = _port_cell(params)
    names = {n for n, _ in cell.named_parameters()}
    assert names == {"weight_ih", "weight_hh", "bias_ih", "bias_hn"}
    hn = cell.bias_hn.detach().clone()
    opt = torch.optim.Adam(cell.parameters(), lr=1e-2, weight_decay=1e-3)
    for _ in range(3):
        opt.zero_grad()
        cell(_t(h), _t(x)).square().sum().backward()
        opt.step()
    assert torch.equal(cell.bias_hh[:2 * HID], torch.zeros(2 * HID))
    assert not torch.equal(cell.bias_hn, hn) and torch.equal(cell.bias_hh[2 * HID:], cell.bias_hn)


def test_torch_gaussian_rssm_gru_cell_xavier_per_gate():
    cell = GRUCell(IN, HID)
    cell.xavier_(torch.Generator().manual_seed(0))
    for w, fan_in in ((cell.weight_ih, IN), (cell.weight_hh, HID)):
        for gate in range(3):
            std = float(w[gate * HID:(gate + 1) * HID].detach().std())
            assert 0.6 * np.sqrt(2 / (fan_in + HID)) < std < 1.4 * np.sqrt(2 / (fan_in + HID))
    assert not cell.bias_ih.any() and not cell.bias_hn.any()


@pytest.mark.parametrize("min_std", [0.1, 0.5])
def test_torch_gaussian_rssm_stochastic_state_matches_jax(min_std):
    rng = np.random.default_rng(1)
    mean_std = (rng.normal(size=(ROWS, 2 * STOCH)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    (want_mean, want_std), want = jax_stochastic_state(jnp.asarray(mean_std), key, min_std)
    noise = _t(np.asarray(jax.random.normal(key, (ROWS, STOCH))))
    (mean, std), got = compute_stochastic_state(_t(mean_std), noise, min_std)
    for g, w in ((mean, want_mean), (std, want_std), (got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    assert float(std.min()) > min_std
    (_, _), greedy = compute_stochastic_state(_t(mean_std), None, min_std)
    assert torch.equal(greedy, mean)


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg, obs_space = configs(False)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg, obs_space)
    state = dreamer_v1_state_from_jax(jax.tree.map(np.asarray, params))
    return {"jax": (world_model, params), "port": build_agent(port_cfg, "cpu", state), "state": state}


def test_torch_gaussian_rssm_whole_state_carries_over(agents):
    for module, name in zip(agents["port"], ("world_model", "actor", "critic")):
        assert set(module.state_dict()) == set(agents["state"][name]), name
    wm = agents["state"]["world_model"]
    assert wm["recurrent_model.rnn.weight_ih"].shape == (3 * REC, REC)
    assert wm["representation_model.out.weight"].shape[0] == 2 * STOCH


def _obs(rng, n):
    return {"rgb": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.float32) / 255 - 0.5,
            "state": rng.normal(size=(n, 10)).astype(np.float32)}


def test_torch_gaussian_rssm_encoder_and_decoder_match_jax(agents):
    jwm, params = agents["jax"]
    wm = agents["port"][0]
    obs = _obs(np.random.default_rng(3), 3)
    want = jwm.encoder.apply(params["world_model"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
    got = wm.encoder({k: _t(v) for k, v in obs.items()})
    assert got.shape[-1] == 8 * 2 * 2 * 2 + WIDTH
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    latent = np.random.default_rng(4).normal(size=(3, STOCH + REC)).astype(np.float32)
    want = jwm.decode(params["world_model"], jnp.asarray(latent))
    got = wm.decode(_t(latent))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_torch_gaussian_rssm_dynamic_and_imagination_steps_match_jax(agents):
    jwm, params = agents["jax"]
    wm = agents["port"][0]
    wmp = params["world_model"]
    rng = np.random.default_rng(5)
    post = rng.normal(size=(ROWS, STOCH)).astype(np.float32)
    rec = rng.normal(size=(ROWS, REC)).astype(np.float32)
    act = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, ROWS)]
    emb = rng.normal(size=(ROWS, 8 * 2 * 2 * 2 + WIDTH)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jwm.rssm.dynamic(wmp, jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), jnp.asarray(emb), key)
    noise = _t(np.asarray(jax.random.normal(jax.random.split(key)[1], (ROWS, STOCH))))
    got = wm.dynamic(_t(post), _t(rec), _t(act), _t(emb), noise)
    pairs = [("recurrent", got[0], want[0]), ("posterior", got[1], want[1]), ("post_mean", got[2][0], want[2][0]),
             ("post_std", got[2][1], want[2][1]), ("prior_mean", got[3][0], want[3][0]),
             ("prior_std", got[3][1], want[3][1])]
    for name, g, w in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-6, rtol=1e-5, err_msg=name)
    want_prior, want_rec = jwm.rssm.imagination(wmp, jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), key)
    got_prior, got_rec = wm.imagination(_t(post), _t(rec), _t(act), _t(np.asarray(jax.random.normal(key, (ROWS, STOCH)))))
    np.testing.assert_allclose(got_rec.detach().numpy(), np.asarray(want_rec), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got_prior.detach().numpy(), np.asarray(want_prior), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("continues", [False, True], ids=["no_continue", "continue_head"])
@pytest.mark.parametrize("free_nats", [0.0, 3.0])
def test_torch_gaussian_rssm_reconstruction_loss_matches_jax(continues, free_nats):
    rng = np.random.default_rng(7)
    shape = (4, 3)
    recon, obs = (rng.normal(size=shape + (8, 8, 3)).astype(np.float32) for _ in range(2))
    reward_mean, rewards = (rng.normal(size=shape + (1,)).astype(np.float32) for _ in range(2))
    post_mean, prior_mean = (rng.normal(size=shape + (STOCH,)).astype(np.float32) for _ in range(2))
    post_std, prior_std = (rng.uniform(0.1, 2.0, size=shape + (STOCH,)).astype(np.float32) for _ in range(2))
    cont_logits = rng.normal(size=shape + (1,)).astype(np.float32)
    targets = (rng.random(shape + (1,)) > 0.3).astype(np.float32) * 0.99
    want = jax_loss.reconstruction_loss(
        {"rgb": JD.Independent(JD.Normal(jnp.asarray(recon), 1.0), 3)}, {"rgb": jnp.asarray(obs)},
        JD.Independent(JD.Normal(jnp.asarray(reward_mean), 1.0), 1), jnp.asarray(rewards),
        JD.Independent(JD.Normal(jnp.asarray(post_mean), jnp.asarray(post_std)), 1),
        JD.Independent(JD.Normal(jnp.asarray(prior_mean), jnp.asarray(prior_std)), 1), free_nats, 0.7,
        JD.Independent(JD.BernoulliSafeMode(logits=jnp.asarray(cont_logits)), 1) if continues else None,
        jnp.asarray(targets) if continues else None, 0.5)
    got = torch_loss.reconstruction_loss(
        {"rgb": TD.Independent(TD.Normal(_t(recon), 1.0), 3)}, {"rgb": _t(obs)},
        TD.Independent(TD.Normal(_t(reward_mean), 1.0), 1), _t(rewards),
        TD.Independent(TD.Normal(_t(post_mean), _t(post_std)), 1),
        TD.Independent(TD.Normal(_t(prior_mean), _t(prior_std)), 1), free_nats, 0.7,
        TD.Independent(TD.BernoulliSafeMode(_t(cont_logits)), 1) if continues else None,
        _t(targets) if continues else None, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


def test_torch_gaussian_rssm_actor_and_critic_losses_match_jax():
    rng = np.random.default_rng(8)
    lam, disc, mean = (rng.normal(size=(3, 5, 1)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(float(torch_loss.actor_loss(_t(lam * disc))),
                               float(jax_loss.actor_loss(jnp.asarray(lam * disc))), rtol=1e-6)
    want = jax_loss.critic_loss(JD.Independent(JD.Normal(jnp.asarray(mean), 1.0), 1), jnp.asarray(lam),
                                jnp.asarray(disc[..., 0]))
    got = torch_loss.critic_loss(TD.Independent(TD.Normal(_t(mean), 1.0), 1), _t(lam), _t(disc[..., 0]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
