"""One Plan2Explore-on-Dreamer-V2 exploration gradient step of the port
against the JAX package's ``p2e_dv2_exploration.make_train_step``, on the
CPU, at the tiny size of ``tests/test_torch_rssm_v2_step.py`` (batch 2 x
sequence 4, horizon 3, recurrent state 24) with 3 ensemble members, from
the same converted parameters (``p2e_dv2_state_from_jax``) and fresh AdamW
states, on JAX's own draws (the keys' splits rebuilt: ``fold_in`` of the
device index, ``split(key, G)``; ``k_dyn, k_img_expl, k_img_task``; per
dynamic step ``k_prior, k_post``; per imagination step ``k_act, k_prior``);
for a discrete actor (REINFORCE on a graph-free imagination) and a
``trunc_normal`` one at ``objective_mix`` 0 with the continue head (the
actors' gradients through the imagined RSSM steps).

Tolerances (float32 both sides): the fourteen metrics within 1e-5 relative
(1e-6 absolute for the near-zero ones), the intrinsic reward positive;
every parameter of every module after the step (the world model, the
ensembles, both actors, both critics and both targets) within 1e-6; the
first step's hard copies leave each target its critic as it was. A second
test counts the plain ``gru_gates_ln`` calls of one step: T + 2H.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv2.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv2.agent import STATE_KEYS, build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import p2e_dv2_state_from_jax
from tests.test_torch_rssm_v2_step import B, H, N_ACT, REC, T, TINY, batch, jax_imagination_noise, jax_posterior_noise

EXPLORE = [t for t in TINY if not t.startswith("exp=")] + [
    "exp=p2e_dv2_exploration",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.ensembles.n=3",
    "algo.ensembles.dense_units=8",
    "algo.ensembles.mlp_layers=1",
]
VARIANTS = {
    "discrete": (False, []),
    "trunc_normal": (True, ["algo.actor.objective_mix=0.0", "algo.world_model.use_continues=True"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(continuous: bool, extra=()):
    import gymnasium as gym

    cfg = compose(EXPLORE + list(extra))
    obs_space = gym.spaces.Dict(
        {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)}
    )
    actions = ({"shape": [N_ACT], "low": [-1.0] * N_ACT, "high": [1.0] * N_ACT, "continuous": True} if continuous
               else {"n": [N_ACT], "continuous": False})
    spaces = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
              "actions": actions}
    return cfg, dotdict({**jax_plain(cfg), "spaces": spaces}), obs_space


def jax_noise(key, stoch, discrete, kind):
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    k_dyn, k_expl, k_task = jax.random.split(jax.random.split(key, 1)[0], 3)
    return {"posterior": jax_posterior_noise(k_dyn, stoch, discrete),
            "exploration": jax_imagination_noise(k_expl, stoch, discrete, T * B, kind),
            "task": jax_imagination_noise(k_task, stoch, discrete, T * B, kind)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def step(request):
    kind = request.param
    continuous, extra = VARIANTS[kind]
    cfg, port_cfg, obs_space = configs(continuous, extra)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), continuous, cfg, obs_space)
    before = jax.tree.map(np.array, params)
    a = cfg.algo
    txs = {
        "world": jax_build_optimizer(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "actor_task": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_task": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
        "actor_exploration": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_exploration": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
        "ensembles": jax_build_optimizer(a.ensembles.optimizer, max_grad_norm=a.ensembles.clip_gradients),
    }
    opts = {"world": txs["world"].init(params["world_model"]),
            **{k: txs[k].init(params[k]) for k in ("actor_task", "critic_task", "actor_exploration",
                                                    "critic_exploration", "ensembles")}}
    train_fn = jax_make_train_step(world_model, ens_module, actor, critic, cfg, fabric.mesh, (N_ACT,), continuous,
                                   txs)
    data = batch(continuous)
    key = jax.random.PRNGKey(23)
    params, opts, metrics = train_fn(params, opts, data, key, jnp.int32(0))
    S, D = int(a.world_model.stochastic_size), int(a.world_model.discrete_size)

    agent = build_agent(port_cfg, "cpu", p2e_dv2_state_from_jax(before))
    train = make_train_step(agent, make_optimizers(port_cfg, agent), port_cfg)
    port_metrics = train({k: torch.from_numpy(v) for k, v in data.items()}, 0, noise=[jax_noise(key, S, D, kind)])
    return {
        "kind": kind,
        "jax": {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": p2e_dv2_state_from_jax(jax.tree.map(np.asarray, params))},
        "port": {"metrics": dict(zip(METRIC_NAMES, port_metrics[0].tolist())),
                 "params": {k: {n: v.detach().clone() for n, v in sd.items()} for k, sd in agent.state().items()}},
        "before": p2e_dv2_state_from_jax(before),
    }


def test_torch_explore_v2_step_metrics_match_jax(step):
    assert set(step["jax"]["metrics"]) == set(METRIC_NAMES)
    for name in METRIC_NAMES:
        got = step["port"]["metrics"][name]
        assert np.isfinite(got), name
        np.testing.assert_allclose(got, step["jax"]["metrics"][name], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{step['kind']} {name}")
    assert step["jax"]["metrics"]["Rewards/intrinsic"] > 0.0


@pytest.mark.parametrize("module", STATE_KEYS)
def test_torch_explore_v2_step_parameters_match_jax(step, module):
    got, want, before = step["port"]["params"][module], step["jax"]["params"][module], step["before"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{step['kind']} {module}.{name}")
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
    if module.startswith("target_critic"):  # the first step's hard copy: the critic as it was
        source = step["before"][module[len("target_"):]]
        for name, value in want.items():
            np.testing.assert_array_equal(value.numpy(), source[name].numpy())
    else:
        assert moved > 0, f"the step left every {module} parameter where it was"


def test_torch_explore_v2_step_counts_the_plain_gru_calls(monkeypatch):
    """Every rollout and imagination step's GRU gates: T + 2H a step (on the
    card ``gru_gates_ln`` launches)."""
    from sheeprl_tpu_torch.ops.kernels import gru

    calls = []
    plain = gru.gru_gates_ln_reference
    monkeypatch.setattr(gru, "gru_gates_ln_reference", lambda *a: calls.append(a[0].shape) or plain(*a))
    _, port_cfg, _ = configs(False)
    agent = build_agent(port_cfg, "cpu")
    train = make_train_step(agent, make_optimizers(port_cfg, agent), port_cfg)
    metrics = train({k: torch.from_numpy(v) for k, v in batch(False).items()}, 0, torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics).all() and metrics.shape == (1, len(METRIC_NAMES))
    assert len(calls) == T + 2 * H
    assert calls.count((T * B, 3 * REC)) == 2 * H
