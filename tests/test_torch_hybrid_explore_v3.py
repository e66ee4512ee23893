"""Plan2Explore-on-DreamerV3's hybrid burst step against the JAX package's,
on the CPU, at the size of ``tests/test_torch_explore_step.py`` (batch 2 x
sequence 4, horizon 3, 3 ensemble members), from the same converted
parameters; and the retry of a burst killed part way.

- The burst: ``make_train_step(..., ring=...)`` at the harness's
  ``grad_chunk`` (replay ratio 1 x 2 envs x 2 = 4), one flush of ragged
  rows, 2 granted steps, the carry ``(moments, cum)``. JAX's draws are
  rebuilt from the burst key (per step ``k_env, k_start, k_grad``, then the
  step's ``k_dyn, k_img_expl, k_img_task``) and injected. Tolerances: the
  ring after the append bit for bit; the fifteen mean metrics (a dict keyed
  by name on both sides) within rtol 1e-5, atol 1e-6; every ``Moments``
  state within rtol 1e-5, atol 1e-6 (the task's quantiles are near 0 after
  two steps); every parameter of every module within 1e-6 but
  for elements whose gradient was below 1e-3 of its tensor's RMS at a step,
  held within 2 lr (at most 0.1 % of a module's elements), as
  ``tests/test_torch_hybrid_v2.py`` holds V2's.
- The retry: the trainer thread dies (``ThreadKilled``) inside a burst,
  after the world model's and the ensembles' updates and before the
  exploration actor's; after the restart the run ends bit-equal to an
  unfaulted one: every module (both critics' EMA targets included), every
  optimizer, the ring's generator and the ``Moments`` of the carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import (
    ExplorationLearner,
    critics_spec,
    initial_moments,
    make_optimizers,
    make_train_step,
    metric_names,
)
from sheeprl_tpu_torch.utils.convert import p2e_dv3_state_from_jax
from tests.test_torch_explore_step import B, N_ACT, T, _imagination, _jax_txs, _uniform, configs
from tests.test_torch_hybrid_v2 import (
    GradFlags,
    assert_params_match,
    assert_same_run,
    blob_values,
    burst_parity,
    retry_run,
    ring_spec,
    ring_values,
)

TRAIN_EVERY = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moments(m):
    return {"task": {k: float(v) for k, v in m["task"].items()},
            "exploration": {n: {k: float(v) for k, v in s.items()} for n, s in m["exploration"].items()}}


@pytest.fixture(scope="module")
def burst():
    cfg, port_cfg, obs_space = configs(False)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, spec_c, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg,
                                                                               obs_space)
    before = p2e_dv3_state_from_jax(jax.tree.map(np.array, params))
    txs = _jax_txs(cfg, spec_c)
    opts = {
        **{n: txs[n].init(params["world_model" if n == "world" else n])
           for n in ("world", "actor_task", "critic_task", "actor_exploration", "ensembles")},
        "critics_exploration": {k: txs["critics_exploration"][k].init(params["critics_exploration"][k]["module"])
                                for k in spec_c},
    }
    spec, keys = ring_spec(cfg, TRAIN_EVERY, True, port_cfg)
    ring, rng = ring_values(keys)
    bucket = spec["stage_buckets"][0]
    values = blob_values(ring, rng, spec["grad_chunk"], bucket)
    jax_burst = jax_make_train_step(world_model, ens_module, actor, critic, spec_c, cfg, fabric.mesh, (N_ACT,), False,
                                    txs, ring={**spec, "ring_keys": keys})
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)

    def noise_of(k_grad):
        k_dyn, k_expl, k_task = jax.random.split(k_grad, 3)
        posterior = np.stack([_uniform(k, (B, S, D)).reshape(B, -1) for k in jax.random.split(k_dyn, T)])
        return {"posterior": torch.from_numpy(posterior.astype(np.float32)),
                "exploration": _imagination(k_expl, S, D, False), "task": _imagination(k_task, S, D, False)}

    agent = build_agent(port_cfg, "cpu", before)
    optimizers = make_optimizers(port_cfg, agent)
    flags = GradFlags(optimizers)
    port_burst = make_train_step(agent, optimizers, port_cfg, ring={**spec, "ring_keys": keys})
    jax_moments = {"task": jax_init_moments(), "exploration": {k: jax_init_moments() for k in spec_c}}
    jax_out, port_out = burst_parity(
        jax_burst, (params, opts, jax_moments, jnp.int32(0)), port_burst,
        (initial_moments(agent, "cpu"), torch.zeros((), dtype=torch.int64)), ring, values, bucket, keys, spec,
        jax.random.PRNGKey(29), noise_of)
    return {"spec": spec, "jax": jax_out, "port": port_out, "flags": flags, "before": before,
            "modules": {k: getattr(agent, k) for k in before if isinstance(getattr(agent, k, None), torch.nn.Module)},
            "names": metric_names(critics_spec(port_cfg))}


def test_torch_hybrid_explore_v3_ring_and_counter_match_jax(burst):
    assert burst["spec"]["grad_chunk"] == 4
    for k, want in burst["jax"][1].items():
        np.testing.assert_array_equal(burst["port"][1][k], want, err_msg=k)
    assert int(burst["port"][0][1]) == int(burst["jax"][0][3]) == 2


def test_torch_hybrid_explore_v3_metrics_and_moments_match_jax(burst):
    got, want = burst["port"][2], burst["jax"][2]
    assert list(got) == burst["names"] and set(burst["names"]) <= set(want)  # JAX also logs its value means
    for name in burst["names"]:
        assert np.isfinite(float(got[name])), name
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, atol=1e-6, err_msg=name)
    port_m, jax_m = _moments(burst["port"][0][0]), jax.tree.map(float, burst["jax"][0][2])
    for part in ("task", "exploration"):
        flat_p, flat_j = jax.tree.leaves(port_m[part]), jax.tree.leaves(jax_m[part])
        np.testing.assert_allclose(flat_p, flat_j, rtol=1e-5, atol=1e-6, err_msg=part)


def test_torch_hybrid_explore_v3_parameters_match_jax(burst):
    jax_state = p2e_dv3_state_from_jax(jax.tree.map(np.asarray, burst["jax"][0][0]))
    modules = {k: m for k, m in burst["modules"].items() if k in jax_state}
    assert len(modules) >= 5
    assert_params_match(modules, jax_state, burst["before"], burst["flags"], "p2e_dv3")


@pytest.fixture(scope="module")
def retried():
    cfg, port_cfg, _ = configs(False)
    port_cfg.algo["hybrid_player"] = {"train_every": TRAIN_EVERY}
    port_cfg["fault"] = {"supervisor": {"backoff": 0, "max_restarts": 2}}
    _, keys = ring_spec(cfg, TRAIN_EVERY, True, port_cfg)
    runs = {}
    for crash_at in (0, 6):  # the 6th exploration-actor update: the 2nd burst's 2nd step
        learner = ExplorationLearner(port_cfg, torch.device("cpu"), None)
        carry = (learner.moments, torch.zeros((), dtype=torch.int64))
        runs[crash_at] = retry_run(learner, port_cfg, keys, crash_at, carry, crash_opt="actor_exploration")
    return runs


def test_torch_hybrid_explore_v3_retry_ends_bit_equal_to_the_unfaulted_run(retried):
    clean, faulted = retried[0], retried[6]
    assert clean["restarts"] == 0 and faulted["restarts"] == 1
    assert faulted["hp"].trainer._rollback.restores == 1
    assert clean["hp"].gradient_steps == faulted["hp"].gradient_steps == 3 * clean["hp"].grad_chunk == 12
    assert int(clean["carry"][1]) == int(faulted["carry"][1]) == 12
    assert_same_run(clean, faulted)
    for a, b in zip(jax.tree.leaves(_moments(clean["carry"][0])), jax.tree.leaves(_moments(faulted["carry"][0]))):
        assert a == b
