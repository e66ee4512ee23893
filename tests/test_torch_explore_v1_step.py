"""One Plan2Explore-on-Dreamer-V1 exploration gradient step of the port
against the JAX package's ``p2e_dv1_exploration.make_train_step``, on the
CPU, at the size of ``tests/test_torch_rssm_v1_step.py`` (2 layers of width
32, batch 3 x sequence 4, horizon 3) with 3 ensemble members, from the same
converted parameters (``p2e_dv1_state_from_jax``) and fresh Adam states, on
JAX's own draws (the keys' splits rebuilt: ``fold_in`` of the device index,
``split(key, G)``; ``k_dyn, k_img_expl, k_img_task``; per dynamic step
``k_prior, k_post``; per imagination step ``k_act, k_prior``); for a discrete
actor and a ``tanh_normal`` one with the continue head, both learning by
dynamics backpropagation through the imagined RSSM steps.

Tolerances (float32 both sides): the fourteen metrics within 1e-5 relative
(1e-6 absolute for the near-zero ones), the intrinsic reward positive;
every parameter of every module after the step (the world model, the
ensembles, both actors, both critics) within 1e-6. The members regress the
next embedded observation; a one-row sequence regresses its only row.
"""

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv1.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv1.agent import STATE_KEYS, build_agent
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import (
    METRIC_NAMES,
    ensemble_loss,
    make_optimizers,
    make_train_step,
)
from sheeprl_tpu_torch.utils.convert import p2e_dv1_state_from_jax
from tests.test_torch_rssm_v1_step import (
    B,
    N_ACT,
    T,
    TINY,
    batch,
    configs,
    jax_imagination_noise,
    jax_posterior_noise,
)

EXPLORE = [t for t in TINY if not t.startswith("exp=")] + [
    "exp=p2e_dv1_exploration",
    "algo.ensembles.n=3",
    "algo.ensembles.dense_units=16",
    "algo.ensembles.mlp_layers=2",
]
VARIANTS = {
    "discrete": (False, []),
    "tanh_normal": (True, ["algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0.0"]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(key, continuous: bool):
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    k_dyn, k_expl, k_task = jax.random.split(jax.random.split(key, 1)[0], 3)
    return {"posterior": jax_posterior_noise(k_dyn),
            "exploration": jax_imagination_noise(k_expl, T * B, continuous),
            "task": jax_imagination_noise(k_task, T * B, continuous)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def step(request):
    kind = request.param
    continuous, extra = VARIANTS[kind]
    cfg, port_cfg, obs_space = configs(continuous, extra, base=EXPLORE)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), continuous, cfg, obs_space)
    before = p2e_dv1_state_from_jax(jax.tree.map(np.array, params))
    a = cfg.algo
    txs = {
        "world": jax_build_optimizer(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "ensembles": jax_build_optimizer(a.ensembles.optimizer, max_grad_norm=a.ensembles.clip_gradients),
        "actor_task": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_task": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
        "actor_exploration": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic_exploration": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
    }
    opts = {"world": txs["world"].init(params["world_model"]),
            **{k: txs[k].init(params[k]) for k in ("ensembles", "actor_task", "critic_task", "actor_exploration",
                                                    "critic_exploration")}}
    train_fn = jax_make_train_step(world_model, ens_module, actor, critic, cfg, fabric.mesh, (N_ACT,), continuous,
                                   txs)
    data = batch(continuous, seed=3)
    key = jax.random.PRNGKey(41)
    params, opts, metrics = train_fn(params, opts, data, key)

    agent = build_agent(port_cfg, "cpu", before)
    train = make_train_step(agent, make_optimizers(port_cfg, agent), port_cfg)
    port_metrics = train({k: torch.from_numpy(v) for k, v in data.items()}, noise=[jax_noise(key, continuous)])
    return {
        "kind": kind,
        "jax": {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": p2e_dv1_state_from_jax(jax.tree.map(np.asarray, params))},
        "port": {"metrics": dict(zip(METRIC_NAMES, port_metrics[0].tolist())),
                 "params": {k: {n: v.detach().clone() for n, v in sd.items()} for k, sd in agent.state().items()}},
        "before": before,
    }


def test_torch_explore_v1_step_metrics_match_jax(step):
    assert set(step["jax"]["metrics"]) == set(METRIC_NAMES)
    for name in METRIC_NAMES:
        got = step["port"]["metrics"][name]
        assert np.isfinite(got), name
        np.testing.assert_allclose(got, step["jax"]["metrics"][name], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{step['kind']} {name}")
    assert step["jax"]["metrics"]["Rewards/intrinsic"] > 0.0


@pytest.mark.parametrize("module", STATE_KEYS)
def test_torch_explore_v1_step_parameters_match_jax(step, module):
    got, want, before = step["port"]["params"][module], step["jax"]["params"][module], step["before"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{step['kind']} {module}.{name}")
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
    assert moved > 0, f"the step left every {module} parameter where it was"


def test_torch_explore_v1_ensembles_regress_the_next_embedding():
    """Member i's loss is its unit-variance Normal NLL of ``embedded[1:]``
    from rows ``[:-1]``; on a one-row sequence, of that row."""
    _, port_cfg, _ = configs(False, base=EXPLORE)
    agent = build_agent(port_cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    posts, recs = torch.randn(T, B, 8, generator=gen), torch.randn(T, B, 32, generator=gen)
    acts, emb = torch.randn(T, B, N_ACT, generator=gen), torch.randn(T, B, 96, generator=gen)
    with torch.no_grad():
        pred = agent.ensembles(torch.cat([posts, recs, acts], dim=-1))
        want = sum(float((0.5 * (emb[1:] - pred[i, :-1]) ** 2 + 0.5 * np.log(2 * np.pi)).sum(-1).mean())
                   for i in range(3))
        assert float(ensemble_loss(agent, posts, recs, acts, emb)) == pytest.approx(want, rel=1e-5)
        one = ensemble_loss(agent, posts[:1], recs[:1], acts[:1], emb[:1])
        want_one = sum(float((0.5 * (emb[0] - pred[i, 0]) ** 2 + 0.5 * np.log(2 * np.pi)).sum(-1).mean())
                       for i in range(3))
        assert float(one) == pytest.approx(want_one, rel=1e-5)
