"""One block of the port's single-run Anakin loop (``make_anakin_block``)
against the JAX package's ``make_anakin_block`` on a one-device CPU mesh.

A small size of the recipe: CartPole with a 5-step time limit (every
episode is cut, so the truncation bootstrap runs), 4 envs x 16 rollout
steps, 2 epochs of 4 minibatches of 16, 2 iterations in one block. Both
sides start from the same flax weights (``ppo_state_from_jax``), a fresh
Adam and the same env state. The port is fed JAX's own draws: each step's
categorical uniforms from the rollout key's splits, each env's reset
uniforms from its reset key (split on every step, moved on only where the
episode ended, which JAX's episode flags say), and each iteration's
permutations from its train key.

Held: every iteration's episode flags, returns and lengths exactly (the
same actions were drawn); the three mean losses within rtol 1e-5; the final
observations within 1e-5 (the envs' float32 rounding differs from XLA's,
see ``test_torch_device_envs.py``); every parameter after the 16 Adam steps
within 1e-6 (the largest gap reads 3.6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.ppo_anakin import make_anakin_block as jax_make_anakin_block
from sheeprl_tpu.config import compose
from sheeprl_tpu.envs.jax_envs import BatchedJaxEnv, make_jax_env
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.algos.ppo.ppo_anakin import AnakinCarry, make_anakin_block, read_block
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.envs.device_envs import BatchedDeviceEnv, CartPoleState, make_device_env
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax

N, T, EPOCHS, MB, ITERS, LIMIT = 4, 16, 2, 16, 2, 5
ROWS = N * T
TINY = float(np.finfo(np.float32).tiny)
OVERRIDES = [f"env.num_envs={N}", f"algo.rollout_steps={T}", f"algo.update_epochs={EPOCHS}",
             f"algo.per_rank_batch_size={MB}", f"env.max_episode_steps={LIMIT}"]


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_permutations(key, epochs, rows):
    """``make_local_train``'s per-epoch permutations on device 0 of the mesh."""
    key = jax.random.fold_in(key, 0)
    return np.stack([np.asarray(jax.random.permutation(k, rows)) for k in jax.random.split(key, epochs)])


def jax_draws(env_key, reset_keys, train_keys, ep_done, n_heads_dims=(2,), reset_shape=(4,)):
    """The draws JAX's block made, per iteration, as the port's ``draws``:
    the rollout key carried across iterations (``key, akey = split(key)`` per
    step, one split of ``akey`` per head), the per-env reset keys (split
    every step, moved on where done) and each iteration's train key."""
    key = jnp.asarray(env_key)
    keys = np.asarray(reset_keys)
    out = []
    for i in range(len(train_keys)):
        uniforms = [[] for _ in n_heads_dims]
        reset = []
        for t in range(T):
            key, akey = jax.random.split(key)
            for h, (k, d) in enumerate(zip(jax.random.split(akey, len(n_heads_dims)), n_heads_dims)):
                uniforms[h].append(_t(jax.random.uniform(k, (N, d), minval=TINY, maxval=1.0)))
            subs = [jax.random.split(jnp.asarray(k)) for k in keys]
            reset.append(torch.stack([_t(jax.random.uniform(s[1], reset_shape)) for s in subs]))
            keys = np.stack([np.asarray(s[0]) if ep_done[i][t][e] else keys[e] for e, s in enumerate(subs)])
        out.append({"uniforms": [torch.stack(u) for u in uniforms], "reset": torch.stack(reset),
                    "perms": _t(jax_permutations(jnp.asarray(train_keys[i]), EPOCHS, ROWS))})
    return out


def jax_agent(cfg):
    return JaxPPOAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                       encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                       critic_cfg=dict(cfg.algo.critic))


def jax_tx(cfg):
    return optax.inject_hyperparams(
        lambda learning_rate: jax_build_optimizer({**cfg.algo.optimizer, "lr": learning_rate},
                                                  max_grad_norm=cfg.algo.max_grad_norm)
    )(learning_rate=float(cfg.algo.optimizer.lr))


@pytest.fixture(scope="module")
def block_pair():
    cfg = compose(["exp=ppo_anakin", "env.id=CartPole-v1", "algo.mlp_keys.encoder=[state]"] + OVERRIDES)
    fabric = Fabric(devices=1, accelerator="cpu")
    agent = jax_agent(cfg)
    params = agent.init(jax.random.PRNGKey(0), {"state": jnp.zeros((1, 4), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = jax_tx(cfg)
    jenv = make_jax_env("CartPole-v1", max_episode_steps=LIMIT)
    benv = BatchedJaxEnv(jenv, N)
    env_state, obs = jax.jit(benv.reset)(jax.random.PRNGKey(5))
    start = {"physics": np.asarray(env_state.env_state.physics), "t": np.asarray(env_state.env_state.t),
             "keys": np.asarray(env_state.keys), "obs": np.asarray(obs)}
    env_keys = jax.random.split(jax.random.PRNGKey(6), 1)
    train_key = jax.random.PRNGKey(7)
    block = jax_make_anakin_block(agent, tx, cfg, fabric.mesh, benv, N, ITERS, "state", ferry_episodes=True,
                                  guard=False)
    out = block(params, tx.init(params), env_state, obs, jnp.zeros((N,), jnp.float32), jnp.zeros((N,), jnp.int32),
                env_keys, train_key, jnp.float32(cfg.algo.clip_coef), jnp.float32(cfg.algo.ent_coef),
                jenv.default_params())
    new_params, _, _, j_obs, j_ret, j_len, _, metrics = out
    metrics = jax.device_get(metrics)
    draws = jax_draws(np.asarray(jax.random.split(jax.random.PRNGKey(6), 1))[0], start["keys"],
                      np.asarray(jax.random.split(train_key, ITERS)), np.asarray(metrics["ep_done"]))

    port_cfg = apply_overrides(preset("ppo_anakin"), OVERRIDES)
    p_agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_state_from_jax(before))
    optimizer = make_optimizer(port_cfg, p_agent)
    optimizer.set_lr(float(np.float32(port_cfg.algo.optimizer.lr)))
    penv = make_device_env("CartPole-v1", max_episode_steps=LIMIT)
    pbenv = BatchedDeviceEnv(penv, N)
    carry = AnakinCarry(CartPoleState(_t(start["physics"]), _t(start["t"])), _t(start["obs"]),
                        torch.zeros(N), torch.zeros(N, dtype=torch.int32))
    block = make_anakin_block(p_agent, optimizer, port_cfg, pbenv, "state")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        carry, p_metrics = block(carry, ITERS, penv.default_params(), torch.tensor(0.2), torch.tensor(0.0),
                                 draws=draws)
    finally:
        torch.set_num_threads(n)
    return {
        "jax": {"params": ppo_state_from_jax(jax.tree.map(np.asarray, new_params)), "metrics": metrics,
                "obs": np.asarray(j_obs), "ep_ret": np.asarray(j_ret), "ep_len": np.asarray(j_len)},
        "port": {"params": {k: v.detach().clone() for k, v in p_agent.state_dict().items()},
                 "metrics": read_block(p_metrics), "carry": carry},
        "before": ppo_state_from_jax(before),
    }


@pytest.mark.parametrize("key", ["ep_done", "ep_ret", "ep_len"])
def test_torch_anakin_block_episodes_match_jax(block_pair, key):
    got, want = block_pair["port"]["metrics"][key], np.asarray(block_pair["jax"]["metrics"][key])
    assert got.shape == want.shape == (ITERS, T, N)
    np.testing.assert_array_equal(got, want)
    if key == "ep_done":
        assert want.sum() >= ITERS * N * (T // LIMIT)  # the 5-step limit cuts every episode at least


@pytest.mark.parametrize("key", ["pg", "v", "ent"])
def test_torch_anakin_block_losses_match_jax(block_pair, key):
    got, want = block_pair["port"]["metrics"][key], np.asarray(block_pair["jax"]["metrics"][key])
    assert got.shape == want.shape == (ITERS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_torch_anakin_block_carry_matches_jax(block_pair):
    carry = block_pair["port"]["carry"]
    np.testing.assert_allclose(carry.obs.numpy(), block_pair["jax"]["obs"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(carry.ep_len.numpy(), block_pair["jax"]["ep_len"])
    np.testing.assert_allclose(carry.ep_ret.numpy(), block_pair["jax"]["ep_ret"], atol=0, rtol=0)


def test_torch_anakin_block_parameters_match_jax(block_pair):
    got, want, before = block_pair["port"]["params"], block_pair["jax"]["params"], block_pair["before"]
    assert set(got) == set(want)
    worst = 0.0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        worst = max(worst, err)
        assert not torch.equal(w, before[name]), name  # every parameter moved
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=name)
    print(f"max parameter error {worst:.3g}")
