"""Dreamer V2's modules and gradient step in the port against the JAX
package's, on the CPU, at a tiny pixel+vector size (batch 2 x sequence 4,
horizon 3, recurrent state 24: not a multiple of 128, so the CPU path sees a
ragged width), from weights carried across by ``dreamer_v2_state_from_jax``.

- The modules: the converted tree loads strictly; the VALID encoder (64 ->
  2) and decoder (1 -> 64), the LayerNorm-GRU recurrent model, the dynamic
  step with ``is_first`` zeroing the carried state, the transition and
  representation heads, on the same inputs and JAX's draws.
- ``reconstruction_loss`` (KL balancing with ``kl_free_avg`` on and off, the
  continue head) and ``compute_lambda_values`` (its bootstrap row) within
  1e-6.
- One gradient step of JAX's ``make_train_step`` and the port's on JAX's own
  draws (the keys' splits rebuilt: ``fold_in`` of the device index,
  ``split(key, G)``; ``k_dyn, k_img``; per dynamic step ``k_prior, k_post``;
  per imagination step ``k_act, k_prior``), with the recipe's AdamW
  (``weight_decay`` 1e-6), for three actors: discrete at ``objective_mix`` 1
  (REINFORCE on a graph-free imagination), ``trunc_normal`` at
  ``objective_mix`` 0 with the continue head and ``kl_free_avg`` off
  (dynamics backpropagation through the imagined RSSM steps), and
  ``tanh_normal`` at 0.5. The ten metrics within 1e-5 relative; every
  parameter of the world model, actor, critic and target critic after the
  update within 1e-6; the first step's hard copy leaves the target critic
  the critic as it was. Sampled one-hots are compared after rounding.
- The plain ``gru_gates_ln`` runs T + H times a step.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.algos.dreamer_v2 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v2.utils import compute_lambda_values as jax_lambda_values
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.algos.dreamer_v2 import loss as torch_loss
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import dreamer_v2_state_from_jax

T, B, H, N_ACT, REC = 4, 2, 3, 3, 24
TINY = [
    "exp=dreamer_v2",
    "env=dummy",
    "env.num_envs=2",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.screen_size=64",
]
VARIANTS = {
    "discrete": (False, []),
    "trunc_normal": (True, ["algo.actor.objective_mix=0.0", "algo.world_model.use_continues=True",
                            "algo.world_model.kl_free_avg=False", "algo.world_model.discount_scale_factor=0.5"]),
    "tanh_normal": (True, ["algo.actor.objective_mix=0.5", "distribution.type=tanh_normal",
                           "algo.world_model.kl_free_nats=0.0", "algo.world_model.kl_regularizer=0.1"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def configs(continuous: bool, extra=()):
    """The JAX config, the port's (the same keys and a ``spaces`` block) and
    the observation space."""
    cfg = compose(TINY + list(extra))
    obs_space = gym.spaces.Dict(
        {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)}
    )
    actions = ({"shape": [N_ACT], "low": [-1.0] * N_ACT, "high": [1.0] * N_ACT, "continuous": True} if continuous
               else {"n": [N_ACT], "continuous": False})
    spaces = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
              "actions": actions}
    return cfg, dotdict({**jax_plain(cfg), "spaces": spaces}), obs_space


def batch(continuous: bool):
    rng = np.random.default_rng(0)
    actions = (rng.uniform(-1, 1, (1, T, B, N_ACT)).astype(np.float32) if continuous
               else np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))])
    data = {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3)).astype(np.float32),
        "state": rng.normal(size=(1, T, B, 10)).astype(np.float32),
        "actions": actions,
        "rewards": (rng.normal(size=(1, T, B, 1)) * 3).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["is_first"][:, 2, 0] = 1.0
    data["terminated"][:, 1, 0] = 1.0
    data["terminated"][:, 3, 1] = 1.0
    return data


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def jax_imagination_noise(k_img, stoch, discrete, rows, kind):
    """Dreamer V2's imagination draws: per step ``k_act, k_prior``; a
    discrete head's Gumbel uniforms from ``split(k_act, 1)[0]``, a
    ``trunc_normal`` draw's ``uniform(k_act)``, a Normal's ``normal(k_act)``."""
    priors, acts = [], []
    for k in jax.random.split(k_img, H):
        k_act, k_prior = jax.random.split(k)
        priors.append(_uniform(k_prior, (rows, stoch, discrete)).reshape(rows, -1))
        if kind == "discrete":
            acts.append(_uniform(jax.random.split(k_act, 1)[0], (rows, N_ACT)))
        elif kind == "trunc_normal":
            acts.append(np.asarray(jax.random.uniform(k_act, (rows, N_ACT))))
        else:
            acts.append(np.asarray(jax.random.normal(k_act, (rows, N_ACT))))
    return {"imagined_prior": _t(np.stack(priors)), "actions": [_t(np.stack(acts))]}


def jax_posterior_noise(k_dyn, stoch, discrete):
    return _t(np.stack([_uniform(jax.random.split(k)[1], (B, stoch, discrete)).reshape(B, -1)
                        for k in jax.random.split(k_dyn, T)]))


def jax_noise(key, stoch, discrete, kind):
    """The port's injected noise for gradient step 0 of a JAX call with ``key``."""
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    k_dyn, k_img = jax.random.split(jax.random.split(key, 1)[0])
    return {"posterior": jax_posterior_noise(k_dyn, stoch, discrete),
            **jax_imagination_noise(k_img, stoch, discrete, T * B, kind)}


def _txs(cfg):
    a = cfg.algo
    return {
        "world": jax_build_optimizer(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "actor": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
    }


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def step(request):
    kind = request.param
    continuous, extra = VARIANTS[kind]
    cfg, port_cfg, obs_space = configs(continuous, extra)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), continuous, cfg, obs_space)
    before = jax.tree.map(np.array, params)
    txs = _txs(cfg)
    opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"])}
    train_fn = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACT,), continuous, txs)
    data = batch(continuous)
    key = jax.random.PRNGKey(17)
    params, opts, metrics = train_fn(params, opts, data, key, jnp.int32(0))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)

    modules = build_agent(port_cfg, "cpu", dreamer_v2_state_from_jax(before))
    wm, port_actor, port_critic, port_target = modules
    train = make_train_step(wm, port_actor, port_critic, port_target, make_optimizers(port_cfg, wm, port_actor,
                                                                                     port_critic), port_cfg)
    port_metrics = train({k: torch.from_numpy(v) for k, v in data.items()}, 0, noise=[jax_noise(key, S, D, kind)])
    names = ("world_model", "actor", "critic", "target_critic")
    return {
        "kind": kind,
        "jax": {"metrics": [float(m) for m in metrics],
                "params": dreamer_v2_state_from_jax(jax.tree.map(np.asarray, params))},
        "port": {"metrics": port_metrics[0].tolist(),
                 "params": {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
                            for n, m in zip(names, modules)}},
        "before": dreamer_v2_state_from_jax(before),
    }


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[-1] for n in METRIC_NAMES])
def test_torch_rssm_v2_step_metric_matches_jax(step, index):
    got, want = step["port"]["metrics"][index], step["jax"]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{step['kind']} {METRIC_NAMES[index]}")


@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
def test_torch_rssm_v2_step_parameters_match_jax(step, module):
    got, want, before = step["port"]["params"][module], step["jax"]["params"][module], step["before"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{step['kind']} {module}.{name}")
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
    if module == "target_critic":  # the first step's hard copy: the critic as it was before the step
        for name, value in want.items():
            np.testing.assert_array_equal(value.numpy(), step["before"]["critic"][name].numpy())
    else:
        assert moved > 0, f"the step left every {module} parameter where it was"


# -- the modules --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg, obs_space = configs(False)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg, obs_space)
    port = build_agent(port_cfg, "cpu", dreamer_v2_state_from_jax(jax.tree.map(np.asarray, params)))
    return {"jax": (world_model, actor, critic, params), "port": port, "cfg": cfg}


def _obs(rng, n):
    return {"rgb": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.float32) / 255 - 0.5,
            "state": rng.normal(size=(n, 10)).astype(np.float32)}


def test_torch_rssm_v2_whole_state_carries_over(agents):
    _, _, _, params = agents["jax"]
    state = dreamer_v2_state_from_jax(jax.tree.map(np.asarray, params))
    for module, name in zip(agents["port"], ("world_model", "actor", "critic", "target_critic")):
        assert set(module.state_dict()) == set(state[name]), name
    assert any("rnn.fused" in k for k in state["world_model"]) and any("rnn.ln" in k for k in state["world_model"])
    assert any("ConvTranspose_0" in k for k in state["world_model"])


def test_torch_rssm_v2_encoder_and_decoder_match_jax(agents):
    jwm, _, _, params = agents["jax"]
    wm = agents["port"][0]
    obs = _obs(np.random.default_rng(1), 3)
    want = np.asarray(jwm.encoder.apply(params["world_model"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()}))
    got = wm.encoder({k: _t(v) for k, v in obs.items()})
    assert got.shape[-1] == 8 * 2 * 2 * 2 + 8  # the 2x2x(8 mult) pixels and the vector features
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    latent = np.random.default_rng(2).normal(size=(3, 16 + REC)).astype(np.float32)
    want = jwm.decode(params["world_model"], jnp.asarray(latent))
    got = wm.decode(_t(latent))
    assert tuple(got["rgb"].shape) == (3, 64, 64, 3)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_torch_rssm_v2_dynamic_step_matches_jax(agents):
    """``is_first`` rows restart from zeros: their recurrent state equals a
    step from the zero state, as in JAX."""
    jwm, _, _, params = agents["jax"]
    wm = agents["port"][0]
    rng = np.random.default_rng(3)
    n = 4
    post = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, 4))].reshape(n, 16)
    rec = rng.normal(size=(n, REC)).astype(np.float32)
    act = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, n)]
    first = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    obs = _obs(rng, n)
    emb = jwm.encoder.apply(params["world_model"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
    key = jax.random.PRNGKey(4)
    want = jwm.rssm.dynamic(params["world_model"], jnp.asarray(post), jnp.asarray(rec), jnp.asarray(act), emb,
                            jnp.asarray(first), key)
    uniform = _t(_uniform(jax.random.split(key)[1], (n, 4, 4)).reshape(n, 16))
    got = wm.dynamic(_t(post), _t(rec), _t(act), _t(np.asarray(emb)), _t(first), uniform)
    for name, g, w in zip(("recurrent", "posterior", "posterior_logits", "prior_logits"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(np.round(got[1].detach().numpy()), np.round(np.asarray(want[1])))
    zero = wm.dynamic(torch.zeros(n, 16), torch.zeros(n, REC), torch.zeros(n, N_ACT), _t(np.asarray(emb)),
                      torch.zeros(n, 1), uniform)[0]
    np.testing.assert_array_equal(got[0][first[:, 0] == 1].detach().numpy(), zero[first[:, 0] == 1].detach().numpy())


@pytest.mark.parametrize("free_avg", [True, False], ids=["free_avg", "free_each"])
@pytest.mark.parametrize("continues", [False, True], ids=["no_continue", "continue_head"])
def test_torch_rssm_v2_reconstruction_loss_matches_jax(free_avg, continues):
    rng = np.random.default_rng(5)
    shape = (T, B)
    recon = rng.normal(size=shape + (8, 8, 3)).astype(np.float32)
    obs = rng.normal(size=shape + (8, 8, 3)).astype(np.float32)
    reward_mean, rewards = (rng.normal(size=shape + (1,)).astype(np.float32) for _ in range(2))
    prior, post = (rng.normal(size=shape + (4, 4)).astype(np.float32) * 2 for _ in range(2))
    cont_logits = rng.normal(size=shape + (1,)).astype(np.float32)
    targets = (rng.random(shape + (1,)) > 0.3).astype(np.float32) * 0.99
    kw = dict(kl_balancing_alpha=0.8, kl_free_nats=1.0, kl_free_avg=free_avg, kl_regularizer=0.7,
              discount_scale_factor=0.5)
    want = jax_loss.reconstruction_loss(
        {"rgb": JD.Independent(JD.Normal(jnp.asarray(recon), 1.0), 3)}, {"rgb": jnp.asarray(obs)},
        JD.Independent(JD.Normal(jnp.asarray(reward_mean), 1.0), 1), jnp.asarray(rewards), jnp.asarray(prior),
        jnp.asarray(post), pc=JD.Independent(JD.BernoulliSafeMode(logits=jnp.asarray(cont_logits)), 1) if continues
        else None, continue_targets=jnp.asarray(targets) if continues else None, **kw)
    got = torch_loss.reconstruction_loss(
        {"rgb": TD.Independent(TD.Normal(_t(recon), 1.0), 3)}, {"rgb": _t(obs)},
        TD.Independent(TD.Normal(_t(reward_mean), 1.0), 1), _t(rewards), _t(prior), _t(post),
        pc=TD.Independent(TD.BernoulliSafeMode(_t(cont_logits)), 1) if continues else None,
        continue_targets=_t(targets) if continues else None, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


def test_torch_rssm_v2_lambda_values_match_jax():
    rng = np.random.default_rng(6)
    rewards, values, continues = (rng.normal(size=(H + 2, 5, 1)).astype(np.float32) for _ in range(3))
    boot = rng.normal(size=(1, 5, 1)).astype(np.float32)
    for bootstrap in (boot, None):
        want = jax_lambda_values(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(continues) * 0.99,
                                 bootstrap=None if bootstrap is None else jnp.asarray(bootstrap), lmbda=0.95)
        got = compute_lambda_values(_t(rewards), _t(values), _t(continues) * 0.99,
                                    bootstrap=None if bootstrap is None else _t(bootstrap), lmbda=0.95)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_torch_rssm_v2_step_counts_the_plain_gru_calls_and_gates_the_copy(monkeypatch):
    """The GRU gates at every rollout and imagination step (T + H: on the
    card ``gru_gates_ln`` launches), and the hard target copy only where
    ``cum % freq == 0``."""
    from sheeprl_tpu_torch.ops.kernels import gru

    calls = []
    plain = gru.gru_gates_ln_reference
    monkeypatch.setattr(gru, "gru_gates_ln_reference", lambda *a: calls.append(a[0].shape) or plain(*a))
    _, port_cfg, _ = configs(False)
    wm, actor, critic, target = build_agent(port_cfg, "cpu")
    train = make_train_step(wm, actor, critic, target, make_optimizers(port_cfg, wm, actor, critic), port_cfg)
    data = {k: torch.from_numpy(v) for k, v in batch(False).items()}
    with torch.no_grad():
        for p in target.parameters():
            p.add_(1.0)
    stale = {k: v.clone() for k, v in target.state_dict().items()}
    metrics = train(data, 1, torch.Generator().manual_seed(0))  # 1 % 100 != 0: no copy
    assert torch.isfinite(metrics).all()
    assert all(torch.equal(v, stale[k]) for k, v in target.state_dict().items())
    assert len(calls) == T + H and calls[0] == (B, 3 * REC) and calls[-1] == (T * B, 3 * REC)
    critic_now = {k: v.clone() for k, v in critic.state_dict().items()}
    train(data, 100, torch.Generator().manual_seed(0))  # 100 % 100 == 0: the copy, before the step's update
    assert all(torch.equal(v, critic_now[k]) for k, v in target.state_dict().items())
