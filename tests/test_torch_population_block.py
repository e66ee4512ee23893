"""The port's population (``ppo_anakin_population``) against the JAX
package's, on the CPU: one P = 2 block, the PBT truncation step, and a
population of one against the single run.

The P = 2 block: CartPole with a 5-step time limit, 4 envs x 16 steps per
member, 2 epochs of 4 minibatches of 16, 2 iterations; the members differ in
every hyperparameter (lr 1e-3 / 2e-3, clip 0.2 / 0.1, entropy 0 / 0.01,
gamma 0.99 / 0.98, lambda 0.95 / 0.9: the second pair's float32 product
differs from its double one) and in the pole's length (0.5 / 0.75), and
start from two flax inits. The port is fed JAX's draws, member by member, as
in ``test_torch_anakin_block.py``. JAX's block ``vmap``s its members and the
port ``torch.func.vmap``s its forward and gradients over them, so both sum
in batched orders of their own: episodes exact, losses and fitness within
rtol 1e-5, parameters within 1e-6 after 16 Adam steps (the largest gap reads
2.1e-7).

PBT: ``make_pbt_step`` fed JAX's ``randint`` draws (``fold_in(key, i)`` per
hyperparameter and env field) gives JAX's hyperparameters, scenarios and
member copies exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.ppo_anakin_population import HPARAM_KEYS as JAX_HPARAM_KEYS
from sheeprl_tpu.algos.ppo.ppo_anakin_population import PBTConfig as JaxPBTConfig
from sheeprl_tpu.algos.ppo.ppo_anakin_population import make_pbt_step as jax_make_pbt_step
from sheeprl_tpu.algos.ppo.ppo_anakin_population import make_population_block as jax_make_population_block
from sheeprl_tpu.config import compose
from sheeprl_tpu.envs.jax_envs import BatchedJaxEnv, make_jax_env
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo_anakin import AnakinCarry, read_block
from sheeprl_tpu_torch.algos.ppo.ppo_anakin_population import (
    HPARAM_KEYS,
    PBTConfig,
    StackedMembers,
    make_pbt_step,
    make_population_block,
)
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.envs.device_envs import BatchedDeviceEnv, CartPoleState, make_device_env, stack_params
from sheeprl_tpu_torch.optim import build_stacked_optimizer
from sheeprl_tpu_torch.utils.convert import ppo_population_state_from_jax, ppo_state_from_jax
from tests.test_torch_anakin_block import ITERS, LIMIT, N, OVERRIDES, T, _t, jax_agent, jax_draws, jax_tx

P = 2
HPARAMS = {"lr": [1e-3, 2e-3], "clip_coef": [0.2, 0.1], "ent_coef": [0.0, 0.01], "gamma": [0.99, 0.98],
           "gae_lambda": [0.95, 0.9]}
LENGTHS = [0.5, 0.75]


@pytest.fixture(scope="module")
def pair():
    cfg = compose(["exp=ppo_anakin", "env.id=CartPole-v1", "algo.mlp_keys.encoder=[state]"] + OVERRIDES)
    fabric = Fabric(devices=1, accelerator="cpu")
    agent = jax_agent(cfg)
    dummy = {"state": jnp.zeros((1, 4), jnp.float32)}
    params = jax.tree.map(lambda *x: jnp.stack(x), *[agent.init(jax.random.PRNGKey(m), dummy) for m in range(P)])
    before = jax.tree.map(np.asarray, params)
    tx = jax_tx(cfg)
    jenv = make_jax_env("CartPole-v1", max_episode_steps=LIMIT)
    benv = BatchedJaxEnv(jenv, N)
    defaults = jenv.default_params()
    env_params = jax.tree.map(lambda x: jnp.broadcast_to(x, (P,) + x.shape), defaults)
    env_params = env_params._replace(length=jnp.asarray(LENGTHS, jnp.float32))
    env_state, obs = jax.jit(jax.vmap(benv.reset))(jax.random.split(jax.random.PRNGKey(5), P), env_params)
    start = {"physics": np.asarray(env_state.env_state.physics), "t": np.asarray(env_state.env_state.t),
             "keys": np.asarray(env_state.keys), "obs": np.asarray(obs)}
    env_keys = jnp.stack([jax.random.split(k, 1) for k in jax.random.split(jax.random.PRNGKey(6), P)])
    rollout_keys = np.asarray(env_keys)  # the block donates its inputs
    train_keys = jax.random.split(jax.random.PRNGKey(7), P)
    hparams = {k: jnp.asarray(v, jnp.float32) for k, v in HPARAMS.items()}
    block = jax_make_population_block(agent, tx, cfg, fabric.mesh, benv, N, ITERS, "state", pop_size=P,
                                      ferry_episodes=True, guard=False, pbt=None)
    out = block(params, jax.vmap(tx.init)(params), env_state, obs, jnp.zeros((P, N), jnp.float32),
                jnp.zeros((P, N), jnp.int32), env_keys, train_keys, hparams, env_params, jnp.ones((3,), jnp.float32),
                jnp.asarray(False), jax.random.PRNGKey(0))
    new_params, _, _, j_obs, _, _, _, _, _, fitness, metrics = out
    metrics = jax.device_get(metrics)
    per_member = [jax_draws(rollout_keys[m][0], start["keys"][m],
                            np.asarray(jax.random.split(train_keys[m], ITERS)), np.asarray(metrics["ep_done"])[m])
                  for m in range(P)]
    draws = [{"uniforms": [torch.stack([d[i]["uniforms"][0] for d in per_member], dim=1)],
              "reset": torch.stack([d[i]["reset"] for d in per_member], dim=1),
              "perms": torch.stack([d[i]["perms"] for d in per_member])} for i in range(ITERS)]

    port_cfg = apply_overrides(preset("ppo_anakin_population"), OVERRIDES)
    p_agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu")
    members = StackedMembers(p_agent, P, "cpu")
    members.load_state_dict(ppo_population_state_from_jax(before))
    optimizer = build_stacked_optimizer(members.flat, port_cfg.algo.optimizer, port_cfg.algo.max_grad_norm)
    penv = make_device_env("CartPole-v1", max_episode_steps=LIMIT)
    pparams = stack_params([penv.default_params()] * P)._replace(length=torch.tensor(LENGTHS))
    carry = AnakinCarry(CartPoleState(_t(start["physics"]), _t(start["t"])), _t(start["obs"]),
                        torch.zeros(P, N), torch.zeros(P, N, dtype=torch.int32))
    pblock = make_population_block(p_agent, members, optimizer, port_cfg, BatchedDeviceEnv(penv, N), "state")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        carry, p_metrics = pblock(carry, ITERS, pparams, {k: torch.tensor(v) for k, v in HPARAMS.items()},
                                  draws=draws)
    finally:
        torch.set_num_threads(n)
    return {
        "jax": {"params": ppo_population_state_from_jax(jax.tree.map(np.asarray, new_params)), "metrics": metrics,
                "obs": np.asarray(j_obs), "fitness": np.asarray(fitness)},
        "port": {"params": members.state_dict(), "metrics": read_block(p_metrics), "carry": carry},
        "before": ppo_population_state_from_jax(before),
    }


def test_torch_population_block_converts_member_stacked_weights(pair):
    for name, stacked in pair["before"].items():
        assert stacked.shape[0] == P
    for m in range(P):
        init = jax_agent(compose(["exp=ppo_anakin"])).init(jax.random.PRNGKey(m), {"state": jnp.zeros((1, 4))})
        single = ppo_state_from_jax(jax.tree.map(np.asarray, init))
        for name, tensor in single.items():
            assert torch.equal(pair["before"][name][m], tensor)


@pytest.mark.parametrize("key", ["ep_done", "ep_ret", "ep_len"])
def test_torch_population_block_episodes_match_jax(pair, key):
    got, want = pair["port"]["metrics"][key], np.asarray(pair["jax"]["metrics"][key])
    assert got.shape == want.shape == (P, ITERS, T, N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["pg", "v", "ent", "fit"])
def test_torch_population_block_losses_and_fitness_match_jax(pair, key):
    got, want = pair["port"]["metrics"][key], np.asarray(pair["jax"]["metrics"][key])
    assert got.shape == want.shape == (P, ITERS) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if key == "fit":  # CartPole pays 1 a step under every scenario
        np.testing.assert_array_equal(got, np.full((P, ITERS), float(T)))
        np.testing.assert_array_equal(got.mean(axis=1), pair["jax"]["fitness"])


def test_torch_population_block_members_diverge_by_scenario(pair):
    obs = pair["port"]["carry"].obs.numpy()
    np.testing.assert_allclose(obs, pair["jax"]["obs"], atol=1e-5, rtol=1e-5)
    assert not np.array_equal(obs[0], obs[1])


def test_torch_population_block_parameters_match_jax(pair):
    got, want, before = pair["port"]["params"], pair["jax"]["params"], pair["before"]
    assert set(got) == set(want)
    worst = 0.0
    for name, w in want.items():
        assert got[name].shape == w.shape
        for m in range(P):
            assert not torch.equal(w[m], before[name][m]), (name, m)
        worst = max(worst, float((got[name] - w).abs().max()))
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6, rtol=0, err_msg=name)
    print(f"max parameter error {worst:.3g}")


# --------------------------------------------------------------------------- #
# PBT
# --------------------------------------------------------------------------- #


def _pbt_fixture(pop, env_id="Pendulum-v1"):
    base = np.arange(pop, dtype=np.float32)
    hparams = {k: (base + 1.0 + i) / 10.0 for i, k in enumerate(JAX_HPARAM_KEYS)}
    hparams["gamma"] = np.linspace(0.99, 0.9995, pop).astype(np.float32)
    jdefaults = make_jax_env(env_id).default_params()
    fields = {f: np.broadcast_to(np.asarray(getattr(jdefaults, f)), (pop,)).copy() for f in jdefaults._fields}
    fields["length"] = np.linspace(0.5, 2.0, pop).astype(np.float32)
    fields["max_episode_steps"] = (100 + 50 * np.arange(pop)).astype(np.int32)
    return hparams, fields


def _jax_factor_draws(key, pop, nf, n_fields):
    rows = [jax.random.randint(jax.random.fold_in(key, i), (pop,), 0, nf) for i in range(len(JAX_HPARAM_KEYS) + n_fields)]
    return _t(np.stack([np.asarray(r) for r in rows])).long()


@pytest.mark.parametrize("case", ["lr", "gamma-clamped", "env-params", "ties"])
def test_torch_population_pbt_step_matches_jax(case):
    pop = 4
    hparams, fields = _pbt_fixture(pop)
    fitness = np.asarray([3.0, 1.0, 2.0, 0.0], np.float32)
    factors, perturb, env_perturb = (0.8, 1.25), ("lr",), ()
    if case == "gamma-clamped":
        perturb, factors = ("gamma", "gae_lambda"), (1.25,)
    elif case == "env-params":
        perturb, env_perturb = (), ("length", "max_episode_steps")
    elif case == "ties":
        fitness = np.zeros(pop, np.float32)
        perturb = ("lr", "ent_coef")
    key = jax.random.PRNGKey(12)
    jdefaults = make_jax_env("Pendulum-v1").default_params()
    j_env = type(jdefaults)(**{f: jnp.asarray(v) for f, v in fields.items()})
    params = {"w": jnp.asarray(np.arange(pop * 3, dtype=np.float32).reshape(pop, 3))}
    opt = {"mu": jnp.asarray(np.arange(pop, dtype=np.float32) * 10)}
    jstep = jax_make_pbt_step(pop, JaxPBTConfig(num_copy=1, perturb=perturb, factors=factors, env_perturb=env_perturb))
    j_params, j_opt, j_hp, j_env_out = jax.device_get(
        jstep((params, opt, {k: jnp.asarray(v) for k, v in hparams.items()}, j_env, jnp.asarray(fitness), key)))

    pdefaults = make_device_env("Pendulum-v1").default_params()
    p_env = type(pdefaults)(*[_t(fields[f]) for f in pdefaults._fields])
    step = make_pbt_step(pop, PBTConfig(num_copy=1, perturb=perturb, factors=factors, env_perturb=env_perturb))
    idx = _jax_factor_draws(key, pop, len(factors), len(pdefaults._fields))
    member_map, p_hp, p_env_out = step({k: _t(v) for k, v in hparams.items()}, p_env, _t(fitness), idx)
    assert HPARAM_KEYS == JAX_HPARAM_KEYS
    np.testing.assert_array_equal(np.asarray(params["w"])[member_map.numpy()], j_params["w"])
    np.testing.assert_array_equal(np.asarray(opt["mu"])[member_map.numpy()], j_opt["mu"])
    for k in HPARAM_KEYS:
        np.testing.assert_array_equal(p_hp[k].numpy(), np.asarray(j_hp[k]), err_msg=k)
    for f in pdefaults._fields:
        got, want = getattr(p_env_out, f).numpy(), np.asarray(getattr(j_env_out, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    if case == "ties":  # equal fitness: a stable sort maps members onto themselves but the bottom one
        assert member_map.tolist() == [0, 1, 2, 0]
    if case == "gamma-clamped":
        assert float(p_hp["gamma"].max()) <= 0.9999


def test_torch_population_stacked_members_and_adam_gather():
    """A PBT copy moves a member's parameters and Adam state whole."""
    cfg = apply_overrides(preset("ppo_anakin_population"), ["algo.population.size=3"])
    agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu")
    members = StackedMembers(agent, 3, "cpu")
    members.flat.copy_(torch.arange(3, dtype=torch.float32)[:, None].expand_as(members.flat))
    opt = build_stacked_optimizer(members.flat, cfg.algo.optimizer)
    opt.step(torch.ones_like(members.flat) * torch.tensor([[1.0], [2.0], [3.0]]), torch.full((3,), 1e-3))
    views = members.views()
    assert views["critic.out.weight"].shape == (3, 1, 64)
    m2 = opt.exp_avg[2].clone()
    member_map = torch.tensor([0, 1, 0])
    members.flat.copy_(members.flat.index_select(0, member_map))
    opt.gather_(member_map)
    assert torch.equal(members.flat[2], members.flat[0]) and torch.equal(opt.exp_avg[2], opt.exp_avg[0])
    assert not torch.equal(opt.exp_avg[2], m2)
    assert opt.step_count.tolist() == [1.0, 1.0, 1.0]
