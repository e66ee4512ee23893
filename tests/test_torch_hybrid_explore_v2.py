"""Plan2Explore-on-Dreamer-V2's hybrid burst step against the JAX package's,
on the CPU, at the size of ``tests/test_torch_explore_v2_step.py`` (batch 2
x sequence 4, horizon 3, 3 ensemble members), from the same converted
parameters.

The burst: ``make_train_step(..., ring=...)`` at the harness's
``grad_chunk`` (0.2 x 2 envs x 8 = 3), one flush of ragged rows, 2 granted
steps, the carry ``(cum,)`` from 1 with both critics' hard target copies
every 2 steps, so the burst's second step copies. JAX's draws are rebuilt
from the burst key (per step ``k_env, k_start, k_grad``, then the step's
``k_dyn, k_img_expl, k_img_task``) and injected. Tolerances: the ring after
the append bit for bit; the fourteen mean metrics, a dict keyed by name on
both sides, within rtol 1e-5, atol 1e-6; every parameter of every module
(the world model, the ensembles, both actors, both critics and their
targets) within 1e-6 but for elements whose gradient was below 1e-3 of its
tensor's RMS at a step, held within 2 lr (at most 0.1 % of a module's
elements), as ``tests/test_torch_hybrid_v2.py`` holds V2's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv2.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.utils.convert import p2e_dv2_state_from_jax
from tests.test_torch_explore_v2_step import configs
from tests.test_torch_hybrid_v2 import (
    GradFlags,
    assert_params_match,
    blob_values,
    burst_parity,
    ring_spec,
    ring_values,
)
from tests.test_torch_rssm_v2_step import B, N_ACT, T, jax_imagination_noise, jax_posterior_noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def burst():
    cfg, port_cfg, obs_space = configs(False, ["algo.critic.per_rank_target_network_update_freq=2"])
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg, obs_space)
    before = p2e_dv2_state_from_jax(jax.tree.map(np.array, params))
    a = cfg.algo
    kinds = {"world": a.world_model, "actor_task": a.actor, "critic_task": a.critic, "actor_exploration": a.actor,
             "critic_exploration": a.critic, "ensembles": a.ensembles}
    txs = {n: jax_build_optimizer(k.optimizer, max_grad_norm=k.clip_gradients) for n, k in kinds.items()}
    opts = {n: txs[n].init(params["world_model" if n == "world" else n]) for n in kinds}
    spec, keys = ring_spec(cfg, 8, True, port_cfg)
    ring, rng = ring_values(keys)
    bucket = spec["stage_buckets"][0]
    values = blob_values(ring, rng, spec["grad_chunk"], bucket)
    jax_burst = jax_make_train_step(world_model, ens_module, actor, critic, cfg, fabric.mesh, (N_ACT,), False, txs,
                                    ring={**spec, "ring_keys": keys})
    S, D = int(a.world_model.stochastic_size), int(a.world_model.discrete_size)

    def noise_of(k_grad):
        k_dyn, k_expl, k_task = jax.random.split(k_grad, 3)
        return {"posterior": jax_posterior_noise(k_dyn, S, D),
                "exploration": jax_imagination_noise(k_expl, S, D, T * B, "discrete"),
                "task": jax_imagination_noise(k_task, S, D, T * B, "discrete")}

    agent = build_agent(port_cfg, "cpu", before)
    optimizers = make_optimizers(port_cfg, agent)
    flags = GradFlags(optimizers)
    port_burst = make_train_step(agent, optimizers, port_cfg, ring={**spec, "ring_keys": keys})
    jax_out, port_out = burst_parity(jax_burst, (params, opts, jnp.int32(1)), port_burst, (1,), ring, values, bucket,
                                     keys, spec, jax.random.PRNGKey(37), noise_of)
    return {"spec": spec, "jax": jax_out, "port": port_out, "modules": {k: getattr(agent, k) for k in before},
            "flags": flags, "before": before}


def test_torch_hybrid_explore_v2_ring_and_counter_match_jax(burst):
    assert burst["spec"]["grad_chunk"] == 3
    for k, want in burst["jax"][1].items():
        np.testing.assert_array_equal(burst["port"][1][k], want, err_msg=k)
    assert burst["port"][0] == (3,) and int(burst["jax"][0][2]) == 3


def test_torch_hybrid_explore_v2_metrics_match_jax(burst):
    got, want = burst["port"][2], burst["jax"][2]
    assert list(got) == list(METRIC_NAMES) and set(want) == set(METRIC_NAMES)
    for name in METRIC_NAMES:
        assert np.isfinite(float(got[name])), name
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, atol=1e-6, err_msg=name)


def test_torch_hybrid_explore_v2_parameters_match_jax(burst):
    jax_state = p2e_dv2_state_from_jax(jax.tree.map(np.asarray, burst["jax"][0][0]))
    assert_params_match(burst["modules"], jax_state, burst["before"], burst["flags"], "p2e_dv2")
