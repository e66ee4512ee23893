"""Dreamer V1's and Plan2Explore-on-V1's hybrid burst steps against the JAX
package's, on the CPU, at the size of ``tests/test_torch_rssm_v1_step.py``
(2 layers of width 32, batch 3 x sequence 4, horizon 3; 3 ensemble members
for P2E), from the same converted parameters, on a ring built without
``is_first`` (V1's rows have none: four keys and the pixels).

Each burst: ``make_train_step(..., ring=...)`` at the harness's
``grad_chunk`` (``round(replay_ratio x envs x train_every)``), one flush of
ragged rows, 2 granted steps, the carry ``()`` (JAX's ``(params, opts)``:
no counter). JAX's draws are rebuilt from the burst key (``fold_in`` of the
device index, ``split(G)``, per step ``k_env, k_start, k_grad``; V1's step
splits ``k_dyn, k_img``, P2E-DV1's ``k_dyn, k_img_expl, k_img_task``) and
injected. Tolerances: the ring after the append bit for bit; the mean
metrics within rtol 1e-5, atol 1e-6 (P2E's as a dict keyed by name, as
JAX's); every parameter within 1e-6 but for elements whose gradient was
within float32 noise of zero at a step (below 1e-3 of its tensor's RMS),
held within 2 lr (at most 0.1 % of a module's elements), as
``tests/test_torch_hybrid_v2.py`` holds V2's.
"""

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.p2e_dv1.agent import build_agent as jax_build_p2e
from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import make_train_step as jax_make_p2e_step
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import METRIC_NAMES, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as port_p2e
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent as build_p2e
from sheeprl_tpu_torch.utils.convert import dreamer_v1_state_from_jax, p2e_dv1_state_from_jax
from tests.test_torch_explore_v1_step import EXPLORE
from tests.test_torch_hybrid_v2 import (
    GradFlags,
    assert_params_match,
    blob_values,
    burst_parity,
    ring_spec,
    ring_values,
)
from tests.test_torch_rssm_v1_step import B, N_ACT, T, configs, jax_imagination_noise, jax_posterior_noise

TRAIN_EVERY = 10  # V1's replay ratio 0.1 x 2 envs x 10 = 2 steps a burst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _txs(cfg, names):
    a = cfg.algo
    kinds = {"world": "world_model", "actor": "actor", "critic": "critic", "actor_task": "actor",
             "critic_task": "critic", "actor_exploration": "actor", "critic_exploration": "critic",
             "ensembles": "ensembles"}
    kinds = {n: a[kinds[n]] for n in names}
    return {n: jax_build_optimizer(kinds[n].optimizer, max_grad_norm=kinds[n].clip_gradients) for n in names}


def _noise(k_grad, parts):
    keys = jax.random.split(k_grad, len(parts))
    out = {"posterior": jax_posterior_noise(keys[0])}
    for name, k in zip(parts[1:], keys[1:]):
        img = jax_imagination_noise(k, T * B, False)
        out.update(img) if name is None else out.update({name: img})
    return out


@pytest.fixture(scope="module")
def v1():
    cfg, port_cfg, obs_space = configs(False)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg, obs_space)
    before = dreamer_v1_state_from_jax(jax.tree.map(np.array, params))
    txs = _txs(cfg, ("world", "actor", "critic"))
    opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"])}
    spec, keys = ring_spec(cfg, TRAIN_EVERY, False, port_cfg, T, B)
    ring, rng = ring_values(keys)
    bucket = spec["stage_buckets"][0]
    values = blob_values(ring, rng, spec["grad_chunk"], bucket)
    jax_burst = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACT,), False, txs,
                                    ring={**spec, "ring_keys": keys})
    modules = dict(zip(("world_model", "actor", "critic"), build_agent(port_cfg, "cpu", before)))
    optimizers = make_optimizers(port_cfg, *modules.values())
    flags = GradFlags(optimizers)
    port_burst = make_train_step(*modules.values(), optimizers, port_cfg, ring={**spec, "ring_keys": keys})
    jax_out, port_out = burst_parity(jax_burst, (params, opts), port_burst, (), ring, values, bucket, keys, spec,
                                     jax.random.PRNGKey(41), lambda k: _noise(k, ("posterior", None)))
    return {"spec": spec, "keys": keys, "jax": jax_out, "port": port_out, "modules": modules, "flags": flags,
            "before": before, "state_of": dreamer_v1_state_from_jax}


@pytest.fixture(scope="module")
def explore_v1():
    cfg, port_cfg, obs_space = configs(False, base=EXPLORE)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, ens_module, actor, critic, params, _ = jax_build_p2e(fabric, (N_ACT,), False, cfg, obs_space)
    before = p2e_dv1_state_from_jax(jax.tree.map(np.array, params))
    names = ("world", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")
    txs = _txs(cfg, names)
    opts = {n: txs[n].init(params["world_model" if n == "world" else n]) for n in names}
    spec, keys = ring_spec(cfg, TRAIN_EVERY, False, port_cfg, T, B)
    ring, rng = ring_values(keys)
    bucket = spec["stage_buckets"][0]
    values = blob_values(ring, rng, spec["grad_chunk"], bucket)
    jax_burst = jax_make_p2e_step(world_model, ens_module, actor, critic, cfg, fabric.mesh, (N_ACT,), False, txs,
                                  ring={**spec, "ring_keys": keys})
    agent = build_p2e(port_cfg, "cpu", before)
    optimizers = port_p2e.make_optimizers(port_cfg, agent)
    flags = GradFlags(optimizers)
    port_burst = port_p2e.make_train_step(agent, optimizers, port_cfg, ring={**spec, "ring_keys": keys})
    jax_out, port_out = burst_parity(jax_burst, (params, opts), port_burst, (), ring, values, bucket, keys, spec,
                                     jax.random.PRNGKey(43),
                                     lambda k: _noise(k, ("posterior", "exploration", "task")))
    modules = {k: getattr(agent, k) for k in before}
    return {"spec": spec, "keys": keys, "jax": jax_out, "port": port_out, "modules": modules, "flags": flags,
            "before": before, "state_of": p2e_dv1_state_from_jax}


@pytest.fixture(params=["v1", "explore_v1"])
def family(request):
    return request.getfixturevalue(request.param)


def test_torch_hybrid_v1_ring_has_no_is_first_and_appends_like_jax(family):
    assert list(family["keys"]) == ["rgb", "state", "actions", "rewards", "terminated"]
    assert family["spec"]["grad_chunk"] == 2
    for k, want in family["jax"][1].items():
        np.testing.assert_array_equal(family["port"][1][k], want, err_msg=k)


def test_torch_hybrid_v1_carry_has_no_counter(family):
    assert family["port"][0] == () and len(family["jax"][0]) == 2


def test_torch_hybrid_v1_metrics_match_jax(family):
    got, want = family["port"][2], family["jax"][2]
    if isinstance(want, dict):  # P2E: the steps name their metrics
        assert isinstance(got, dict) and set(got) == set(want) == set(port_p2e.METRIC_NAMES)
        pairs = [(k, float(got[k]), float(want[k])) for k in want]
    else:
        pairs = [(n, float(g), float(w)) for n, g, w in zip(METRIC_NAMES, got, want)]
    for name, g, w in pairs:
        assert np.isfinite(g), name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


def test_torch_hybrid_v1_parameters_match_jax(family):
    jax_state = family["state_of"](jax.tree.map(np.asarray, family["jax"][0][0]))
    assert_params_match(family["modules"], jax_state, family["before"], family["flags"])
