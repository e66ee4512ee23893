"""The guarded DreamerV3 host-tier step of the port
(``make_train_step(guard=True)``) against the JAX package's
``make_train_step(guard=True)``, on the CPU, at the tiny pixel+vector size
of ``test_torch_train_step.py``, on batches whose rewards are NaN in chosen
gradient steps.

One call of two gradient steps per case, from the same converted
parameters, fresh optimizers and fresh ``Moments``: the step with NaN
rewards has a non-finite reward loss and gradients, so both sides leave the
four modules, the three Adams and ``Moments`` as they were before its
target-critic EMA, and count only the steps taken for the EMA's cadence
(``cum + ok``): with ``per_rank_target_network_update_freq`` 1 and
``cum0`` 0, a skipped first step means the second step copies the critic
in whole, as the first would have. The draws are JAX's own, rebuilt from
the step keys as ``test_torch_train_step.py`` rebuilds them.

Tolerances as there: the skipped count exact; every parameter of the four
modules within atol 1e-6; ``Moments`` within rtol 1e-5; a fully skipped
call leaves everything bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_train import N_ACTIONS, tiny_configs
from tests.test_torch_train_step import EXTRA, H, B, T, _batch, _uniform

G = 2
MODULES = ("world_model", "actor", "critic", "target_critic")
# case: (cum0, the gradient steps whose rewards are NaN)
CASES = {
    "first-step-at-cum0": (0, [0]),
    "second-step-at-cum0": (0, [1]),
    "first-step-at-cum3": (3, [0]),
    "both-steps": (0, [0, 1]),
}


def _noise(key, g, stoch, discrete):
    """Gradient step ``g``'s uniforms, from the keys ``make_train_step``
    splits for it."""
    step_key = jax.random.split(jax.random.fold_in(key, 0), G)[g]
    k_dyn, k_img = jax.random.split(step_key)
    k0, k_scan = jax.random.split(k_img)
    heads = [[_uniform(k, (T * B, N_ACTIONS))] for k in jax.random.split(k0, 1)]
    priors = []
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        priors.append(_uniform(k_prior, (T * B, stoch, discrete)).reshape(T * B, stoch * discrete))
        for i, kh in enumerate(jax.random.split(k_act, 1)):
            heads[i].append(_uniform(kh, (T * B, N_ACTIONS)))
    posterior = [_uniform(k, (B, stoch, discrete)).reshape(B, stoch * discrete) for k in jax.random.split(k_dyn, T)]
    return {
        "posterior": torch.from_numpy(np.stack(posterior)),
        "imagined_prior": torch.from_numpy(np.stack(priors)),
        "actions": [torch.from_numpy(np.stack(h)) for h in heads],
    }


@pytest.fixture(scope="module")
def guarded():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    before = jax.tree.map(lambda a: np.array(a), params)
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": jax_build_optimizer(cfg.algo.actor.optimizer, max_grad_norm=cfg.algo.actor.clip_gradients),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    train_fn = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs, guard=True)
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    one = _batch()
    out = {"before": dreamer_v3_state_from_jax(before)}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (cum0, poisoned) in CASES.items():
            data = {k: np.concatenate([v] * G, axis=0) for k, v in one.items()}
            for g in poisoned:
                data["rewards"][g, 1, 0] = np.nan
            key = jax.random.PRNGKey(11)
            params = jax.tree.map(jnp.asarray, before)
            opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
                    "critic": txs["critic"].init(params["critic"])}
            params, opts, jax_moments, metrics = train_fn(
                params, opts, jax_init_moments(), data, key, jnp.int32(cum0)
            )

            wm, p_actor, p_critic, p_target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(before))
            optimizers = make_optimizers(port_cfg, wm, p_actor, p_critic)
            port_train = make_train_step(wm, p_actor, p_critic, p_target, optimizers, port_cfg, guard=True)
            noise = [_noise(key, g, S, D) for g in range(G)]
            port_moments, _, skipped = port_train({k: torch.from_numpy(v) for k, v in data.items()}, init_moments(),
                                                  cum0, noise=noise)
            modules = dict(zip(MODULES, (wm, p_actor, p_critic, p_target)))
            out[name] = {
                "jax": {
                    "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, params)),
                    "moments": {k: float(v) for k, v in jax_moments.items()},
                    "skipped": float(metrics[-1]) * G,
                },
                "port": {
                    "params": {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in modules.items()},
                    "moments": {k: float(v) for k, v in port_moments.items()},
                    "skipped": float(skipped),
                    "steps": {int(s["step"]) for o in optimizers.values() for s in o.optimizer.state.values()},
                },
            }
    finally:
        torch.set_num_threads(n_threads)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_torch_fault_rssm_skipped_count_matches_jax(guarded, case):
    got = guarded[case]
    assert got["port"]["skipped"] == got["jax"]["skipped"] == len(CASES[case][1])
    assert got["port"]["steps"] == {G - len(CASES[case][1])}


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("case", list(CASES))
def test_torch_fault_rssm_parameters_match_jax(guarded, case, module):
    got, want = guarded[case]["port"]["params"][module], guarded[case]["jax"]["params"][module]
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.isfinite(got[name]).all(), f"{module}.{name}"
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=f"{module}.{name}")
    if case == "both-steps":
        for name, value in guarded["before"][module].items():
            assert torch.equal(got[name], value), f"{module}.{name} moved in a fully skipped call"


@pytest.mark.parametrize("case", list(CASES))
def test_torch_fault_rssm_moments_match_jax(guarded, case):
    port, jax_ = guarded[case]["port"]["moments"], guarded[case]["jax"]["moments"]
    for k in ("low", "high"):
        np.testing.assert_allclose(port[k], jax_[k], rtol=1e-5, atol=1e-8)


def test_torch_fault_rssm_skipped_first_step_still_copies_the_critic(guarded):
    """``cum0`` 0 with the first step skipped: the step taken copies the
    critic whole (mix 1), so the target critic equals the critic as it was
    before that step, i.e. the initial critic."""
    target = guarded["first-step-at-cum0"]["port"]["params"]["target_critic"]
    for name, value in guarded["before"]["critic"].items():
        torch.testing.assert_close(target[name], value, rtol=0, atol=0)
