"""The port's Plan2Explore modules against the JAX package's
``p2e_dv3.agent.build_agent``, on the CPU, at the tiny size of
``tests/test_torch_explore_step.py``, under weights carried across by
``p2e_dv3_state_from_jax``: the converted tree loads strictly, and every
head (both actors, the task critic and its target, each exploration critic
and its target, the reward and continue heads, and the stacked ensembles
against ``ensembles_apply``'s ``jax.vmap``) gives JAX's output within atol
1e-6 (float32 matmuls summed in another order; flax's one-pass LayerNorm
variance). Then the port's own initialisation from a seed: the members
differ, the exploration critics' output layers are zeros and their targets
copies, the task modules are DreamerV3's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import actor_dists as jax_actor_dists
from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv3.agent import ensembles_apply
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import actor_dists, build_training_agent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import STATE_KEYS, build_agent
from sheeprl_tpu_torch.utils.convert import p2e_dv3_state_from_jax
from tests.test_torch_explore_step import N_ACT, configs


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module", params=[False, True], ids=["discrete", "continuous"])
def agents(request):
    cfg, port_cfg, obs_space = configs(request.param)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, spec, params, _ = jax_build_agent(
        fabric, (N_ACT,), request.param, cfg, obs_space
    )
    numpy_params = jax.tree.map(np.asarray, params)
    port = build_agent(port_cfg, "cpu", p2e_dv3_state_from_jax(numpy_params))
    return {"jax": (world_model, ens_module, actor, critic, spec, numpy_params), "port": port, "cfg": port_cfg}


def test_torch_explore_agent_tree_carries_over(agents):
    *_, spec, params = agents["jax"]
    port = agents["port"]
    assert port.critic_names == tuple(sorted(spec)) == ("extrinsic", "intrinsic")
    state = p2e_dv3_state_from_jax(params)
    assert set(state) == set(STATE_KEYS)
    for key in STATE_KEYS:
        got = getattr(port, key).state_dict()
        assert set(got) == set(state[key]), key
        for name, value in state[key].items():
            torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=f"{key}.{name}")
    assert port.ensembles.model.dense_0.kernel.shape == (3, 16 + 16 + N_ACT, 8)


def test_torch_explore_agent_heads_match_jax(agents):
    world_model, ens_module, actor, critic, spec, params = agents["jax"]
    port = agents["port"]
    latent = np.random.default_rng(0).normal(size=(5, 2, 32)).astype(np.float32)
    x = jnp.asarray(latent)
    wmp = params["world_model"]
    with torch.no_grad():
        heads = [
            ("reward", port.world_model.reward_model, world_model.reward_model.apply(wmp["reward_model"], x)),
            ("continue", port.world_model.continue_model, world_model.continue_model.apply(wmp["continue_model"], x)),
            ("critic_task", port.critic_task, critic.apply(params["critic_task"], x)),
            ("target_critic_task", port.target_critic_task, critic.apply(params["target_critic_task"], x)),
        ]
        for name in spec:
            for role in ("module", "target"):
                heads.append((f"{name}.{role}", port.critics_exploration[name][role],
                              critic.apply(params["critics_exploration"][name][role], x)))
        for name, module, want in heads:
            np.testing.assert_allclose(module(_t(latent)).numpy(), np.asarray(want), atol=1e-6, err_msg=name)
        for name in ("actor_task", "actor_exploration"):
            got = getattr(port, name)(_t(latent))
            want = actor.apply(params[name], x)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
            got_d, want_d = actor_dists(getattr(port, name), got), jax_actor_dists(actor, want)
            np.testing.assert_allclose(got_d[0].mode.numpy(), np.asarray(want_d[0].mode), atol=1e-6, err_msg=name)


def test_torch_explore_agent_ensembles_match_the_vmapped_members(agents):
    _, ens_module, *_, params = agents["jax"]
    port = agents["port"]
    x = np.random.default_rng(1).normal(size=(4, 3, 32 + N_ACT)).astype(np.float32) * 2
    want = np.asarray(ensembles_apply(ens_module, params["ensembles"], jnp.asarray(x)))
    with torch.no_grad():
        got = port.ensembles(_t(x)).numpy()
    assert got.shape == want.shape == (3, 4, 3, 16)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # member m alone is member m of the stack
    for m in range(3):
        one = ens_module.apply(jax.tree.map(lambda a: a[m], params["ensembles"]), jnp.asarray(x))
        np.testing.assert_allclose(got[m], np.asarray(one), atol=1e-6)


def test_torch_explore_agent_own_init_from_a_seed():
    _, port_cfg, _ = configs(False)
    agent = build_agent(port_cfg, "cpu")
    kernels = agent.ensembles.model.dense_0.kernel
    assert not torch.equal(kernels[0], kernels[1]) and not torch.equal(kernels[1], kernels[2])
    assert torch.count_nonzero(agent.ensembles.out.kernel) > 0
    for name, pair in agent.critics_exploration.items():
        assert torch.count_nonzero(pair["module"].out.weight) == 0, name
        for a, b in zip(pair["module"].parameters(), pair["target"].parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not any(p.requires_grad for p in pair["target"].parameters())
    assert not torch.equal(agent.actor_task.head_0.weight, agent.actor_exploration.head_0.weight)
    # the task modules are DreamerV3's, drawn from the same seed
    wm, actor, critic, _ = build_training_agent(port_cfg, "cpu")
    for a, b in ((agent.world_model, wm), (agent.actor_task, actor), (agent.critic_task, critic)):
        for k, v in b.state_dict().items():
            torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)
    # a finetuning checkpoint (no ensembles, no exploration critics) loads
    state = {k: v for k, v in agent.state().items() if k not in ("ensembles", "critics_exploration")}
    again = build_agent(port_cfg, "cpu", state)
    torch.testing.assert_close(again.ensembles.out.kernel, agent.ensembles.out.kernel, rtol=0, atol=0)
