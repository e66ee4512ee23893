"""One Plan2Explore exploration gradient step of the port against the JAX
package's ``p2e_dv3_exploration.make_train_step``, on the CPU, at a tiny
pixel+vector size (batch 2 x sequence 4, horizon 3, 3 ensemble members),
from the same converted parameters (``p2e_dv3_state_from_jax``) and fresh
optimizer states, on a batch with ``is_first`` and ``terminated``
boundaries; for a discrete actor (REINFORCE) and a continuous one
(dynamics backpropagation through the imagined RSSM steps).

Noise: the step's key splits are rebuilt (``fold_in`` of the device index,
``split(key, G)``; ``k_dyn, k_img_expl, k_img_task``; ``split(k_dyn, T)``;
per imagination ``k0, k_scan`` and per step ``k_prior, k_act``). A discrete
head draws Gumbel noise from ``uniform(key, minval=tiny)`` of
``split(k, 1)[0]``; a continuous actor's draw is ``normal(key)``.

Tolerances (float32 both sides): every metric within rtol 1e-5 (atol 1e-6
for the near-zero ones); every parameter of every module after the step
(world model, ensembles, both actors, the task critic and its target, both
exploration critics and their targets) within atol 1e-5 (an Adam step moves
a parameter by about its learning rate, 1e-4 or 8e-5); each ``Moments``
state within rtol 1e-5. A second test counts the plain versions' calls in
one step: ``gru_gates_ln`` T + 2H times, the fused two-hot loss and its
backward 7 times each, the decode 8 times.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv3.agent import STATE_KEYS, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import (
    critics_spec,
    initial_moments,
    make_optimizers,
    make_train_step,
    metric_names,
)
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import p2e_dv3_state_from_jax

T, B, H, N_ACT = 4, 2, 3, 3
TINY = [
    "exp=p2e_dv3_exploration",
    "env=dummy",
    "env.num_envs=2",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.reward_model.bins=17",
    "algo.critic.bins=17",
    "algo.ensembles.n=3",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.screen_size=64",
]


def configs(continuous: bool):
    """The JAX config, the port's (the same keys and a ``spaces`` block) and
    the observation space."""
    cfg = compose(TINY)
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def _imagination(key, stoch, discrete, continuous):
    k0, k_scan = jax.random.split(key)
    priors, act_keys = [], [k0]
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        priors.append(_uniform(k_prior, (T * B, stoch, discrete)).reshape(T * B, -1))
        act_keys.append(k_act)
    if continuous:
        actions = [np.stack([np.asarray(jax.random.normal(k, (T * B, N_ACT))) for k in act_keys])]
    else:  # one head: its key is split(k, 1)[0]
        actions = [np.stack([_uniform(jax.random.split(k, 1)[0], (T * B, N_ACT)) for k in act_keys])]
    return {"imagined_prior": _t(np.stack(priors)), "actions": [_t(a) for a in actions]}


def jax_noise(key, stoch, discrete, continuous):
    """The port's injected noise for gradient step 0 of a JAX call with
    ``key``, rebuilt from the exploration ``make_train_step``'s splits."""
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    k_dyn, k_expl, k_task = jax.random.split(jax.random.split(key, 1)[0], 3)
    posterior = np.stack([_uniform(k, (B, stoch, discrete)).reshape(B, -1) for k in jax.random.split(k_dyn, T)])
    return {
        "posterior": _t(posterior),
        "exploration": _imagination(k_expl, stoch, discrete, continuous),
        "task": _imagination(k_task, stoch, discrete, continuous),
    }


def _jax_txs(cfg, names):
    a = cfg.algo
    return {
        "world": jax_build_optimizer(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "actor_task": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_task": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
        "actor_exploration": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "ensembles": jax_build_optimizer(a.ensembles.optimizer, max_grad_norm=a.ensembles.clip_gradients),
        "critics_exploration": {
            k: jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients) for k in names
        },
    }


@pytest.fixture(scope="module", params=[False, True], ids=["discrete", "continuous"])
def step(request):
    continuous = request.param
    cfg, port_cfg, obs_space = configs(continuous)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, spec, params, _ = jax_build_agent(
        fabric, (N_ACT,), continuous, cfg, obs_space
    )
    before = jax.tree.map(lambda a: np.array(a), params)  # the step donates its inputs
    txs = _jax_txs(cfg, spec)
    opts = {
        "world": txs["world"].init(params["world_model"]),
        "actor_task": txs["actor_task"].init(params["actor_task"]),
        "critic_task": txs["critic_task"].init(params["critic_task"]),
        "actor_exploration": txs["actor_exploration"].init(params["actor_exploration"]),
        "ensembles": txs["ensembles"].init(params["ensembles"]),
        "critics_exploration": {
            k: txs["critics_exploration"][k].init(params["critics_exploration"][k]["module"]) for k in spec
        },
    }
    train_fn = jax_make_train_step(world_model, ens_module, actor, critic, spec, cfg, fabric.mesh, (N_ACT,),
                                   continuous, txs)
    data = batch(continuous)
    moments = {"task": jax_init_moments(), "exploration": {k: jax_init_moments() for k in spec}}
    key = jax.random.PRNGKey(17)
    params, opts, moments, metrics = train_fn(params, opts, moments, data, key, jnp.int32(0))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)

    agent = build_agent(port_cfg, "cpu", p2e_dv3_state_from_jax(before))
    optimizers = make_optimizers(port_cfg, agent)
    train = make_train_step(agent, optimizers, port_cfg)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_moments, port_metrics = train({k: torch.from_numpy(v) for k, v in data.items()},
                                           initial_moments(agent, "cpu"), 0,
                                           noise=[jax_noise(key, S, D, continuous)])
    finally:
        torch.set_num_threads(n_threads)
    return {
        "names": metric_names(critics_spec(port_cfg)),
        "jax": {"params": p2e_dv3_state_from_jax(jax.tree.map(np.asarray, params)),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "moments": jax.tree.map(float, moments)},
        "port": {"params": agent.state(), "metrics": port_metrics[0].tolist(),
                 "moments": jax.tree.map(float, {"task": {k: v.item() for k, v in port_moments["task"].items()},
                                                 "exploration": {n: {k: v.item() for k, v in m.items()}
                                                                 for n, m in port_moments["exploration"].items()}})},
        "before": p2e_dv3_state_from_jax(before),
    }


def test_torch_explore_step_metrics_match_jax(step):
    names = step["names"]
    assert len(names) == 15 and names[8] == "Rewards/intrinsic"
    for name, got in zip(names, step["port"]["metrics"]):
        assert np.isfinite(got), name
        np.testing.assert_allclose(got, step["jax"]["metrics"][name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert step["jax"]["metrics"]["Rewards/intrinsic"] > 0.0


@pytest.mark.parametrize("module", STATE_KEYS)
def test_torch_explore_step_parameters_match_jax(step, module):
    got, want, before = step["port"]["params"][module], step["jax"]["params"][module], step["before"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=f"{module}.{name}")
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
    if module == "target_critic_task":  # the first step copies the critic as it was before the step
        for name, value in want.items():
            np.testing.assert_array_equal(value.numpy(), before[name].numpy())
    else:
        assert moved > 0, f"the step left every {module} parameter where it was"


def test_torch_explore_step_moments_match_jax(step):
    got, want = step["port"]["moments"], step["jax"]["moments"]
    for k in ("low", "high"):
        np.testing.assert_allclose(got["task"][k], want["task"][k], rtol=1e-5, atol=1e-8)
        for name in want["exploration"]:
            np.testing.assert_allclose(got["exploration"][name][k], want["exploration"][name][k], rtol=1e-5,
                                       atol=1e-8, err_msg=name)
    assert want["exploration"]["intrinsic"]["high"] != 0.0


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_torch_explore_step_counts_the_plain_kernel_calls(monkeypatch, continuous):
    """One step, counted where each wrapper takes its plain version on the
    CPU (where on the card it launches its kernel): the GRU gates at every
    rollout and imagination step, the fused two-hot loss and its backward
    in the reward loss and twice in each of the three critics' losses, the
    decode for the two exploration critics' values, the reward, the task's
    value and reward, and the three critic targets."""
    from sheeprl_tpu_torch.ops.kernels import gru, twohot

    counts = {"gru": 0, "lse": 0, "lse_bwd": 0, "decode": 0}

    def counted(name, fn, backward=None):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            out = fn(*args, **kwargs)
            if backward and out.requires_grad:
                out.register_hook(lambda g: counts.__setitem__(backward, counts[backward] + 1))
            return out
        return wrapper

    monkeypatch.setattr(gru, "gru_gates_ln_reference", counted("gru", gru.gru_gates_ln_reference))
    monkeypatch.setattr(twohot, "two_hot_symlog_loss_lse_reference",
                        counted("lse", twohot.two_hot_symlog_loss_lse_reference, "lse_bwd"))
    monkeypatch.setattr(twohot, "two_hot_symexp_decode_reference",
                        counted("decode", twohot.two_hot_symexp_decode_reference))
    _, port_cfg, _ = configs(continuous)
    agent = build_agent(port_cfg, "cpu")
    train = make_train_step(agent, make_optimizers(port_cfg, agent), port_cfg)
    data = {k: torch.from_numpy(v) for k, v in batch(continuous).items()}
    _, metrics = train(data, initial_moments(agent, "cpu"), 0, torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics).all()
    assert counts == {"gru": T + 2 * H, "lse": 7, "lse_bwd": 7, "decode": 8}
