"""Full DreamerV3 gradient steps of the port against the JAX package's
``make_train_step``, on the CPU, at the tiny pixel+vector size of
``tests/test_algos/test_dreamer_scan.py`` (batch 2 x sequence 8, horizon 5,
one gradient step per call), from the same converted parameters and fresh
optimizer state, on a batch with ``is_first`` and ``terminated``
boundaries. Two calls: the first (``cum0`` 0) copies the critic into the
target critic, the second (``cum0`` 1, the same compiled JAX step) mixes it
in at ``tau`` and takes Adam's second step.

Noise: the test rebuilds the key splits of ``make_train_step`` (``fold_in``
of the device index and ``split(key, G)``; ``k_dyn, k_img``; ``split(k_dyn,
T)``; ``k0, k_scan``; per imagination step ``k_prior, k_act``; one key per
actor head) and turns each key into the uniforms ``jax.random.categorical``
draws its Gumbel noise from, after asserting that those uniforms reproduce
JAX's own samples. The port's step takes them as injected noise.

Tolerances (float32 on both sides): the ten metrics within rtol 1e-4, atol
1e-5; every updated parameter of the world model, actor, critic and target
critic within atol 1e-6 (an Adam step moves a parameter by about its
learning rate, 1e-4 or 8e-5, so a wrong update shows at 1e-5); the
``Moments`` state within rtol 1e-5. The JAX step compiles once for the
module.
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
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_train import N_ACTIONS, tiny_configs

T, B, H = 8, 2, 5
EXTRA = [f"algo.per_rank_batch_size={B}", f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}"]


def _batch():
    rng = np.random.default_rng(0)
    data = {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3)).astype(np.float32),
        "state": rng.normal(size=(1, T, B, 10)).astype(np.float32),
        "actions": np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, (1, T, B))],
        "rewards": (rng.normal(size=(1, T, B, 1)) * 3).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["is_first"][:, 3, 0] = 1.0
    data["is_first"][:, 6, 1] = 1.0
    data["terminated"][:, 2, 0] = 1.0
    data["terminated"][:, 5, 1] = 1.0
    return data


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def _key_tree(key, stoch, discrete):
    """The keys ``make_train_step`` derives for gradient step 0, each with
    the shape of the draw it feeds."""
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    step_key = jax.random.split(key, 1)[0]
    k_dyn, k_img = jax.random.split(step_key)
    draws = {"posterior": [(k, (B, stoch, discrete)) for k in jax.random.split(k_dyn, T)]}
    k0, k_scan = jax.random.split(k_img)
    heads = [[(k, (T * B, N_ACTIONS))] for k in jax.random.split(k0, 1)]
    draws["imagined_prior"] = []
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        draws["imagined_prior"].append((k_prior, (T * B, stoch, discrete)))
        for i, kh in enumerate(jax.random.split(k_act, 1)):
            heads[i].append((kh, (T * B, N_ACTIONS)))
    draws["actions"] = heads
    return draws


@pytest.fixture(scope="module")
def step():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    before = jax.tree.map(lambda a: np.array(a), params)  # the step donates its inputs
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": jax_build_optimizer(cfg.algo.actor.optimizer, max_grad_norm=cfg.algo.actor.clip_gradients),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    opts = {
        "world": txs["world"].init(params["world_model"]),
        "actor": txs["actor"].init(params["actor"]),
        "critic": txs["critic"].init(params["critic"]),
    }
    train_fn = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs)
    data = _batch()
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)

    wm, port_actor, port_critic, port_target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(before))
    optimizers = make_optimizers(port_cfg, wm, port_actor, port_critic)
    port_train = make_train_step(wm, port_actor, port_critic, port_target, optimizers, port_cfg)
    port_modules = (("world_model", wm), ("actor", port_actor), ("critic", port_critic), ("target_critic", port_target))
    port_data = {k: torch.from_numpy(v) for k, v in data.items()}

    jax_moments, port_moments = jax_init_moments(), init_moments()
    steps, draws = [], None
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for cum in range(2):
            key = jax.random.PRNGKey(11 + cum)
            params, opts, jax_moments, metrics = train_fn(params, opts, jax_moments, data, key, jnp.int32(cum))
            draws = _key_tree(key, S, D)
            noise = {
                "posterior": torch.from_numpy(
                    np.stack([_uniform(k, s).reshape(B, S * D) for k, s in draws["posterior"]])
                ),
                "imagined_prior": torch.from_numpy(
                    np.stack([_uniform(k, s).reshape(T * B, S * D) for k, s in draws["imagined_prior"]])
                ),
                "actions": [torch.from_numpy(np.stack([_uniform(k, s) for k, s in head])) for head in draws["actions"]],
            }
            port_moments, port_metrics, _ = port_train(port_data, port_moments, cum, noise=[noise])
            steps.append({
                "jax": {
                    "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, params)),
                    "moments": {k: float(v) for k, v in jax_moments.items()},
                    "metrics": [float(m) for m in metrics],
                },
                "port": {
                    "params": {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in port_modules},
                    "moments": {k: float(v) for k, v in port_moments.items()},
                    "metrics": port_metrics[0].tolist(),
                },
            })
    finally:
        torch.set_num_threads(n_threads)
    return {"steps": steps, "before": dreamer_v3_state_from_jax(before), "draws": draws}


def test_torch_train_step_uniforms_reproduce_jax_samples(step):
    """Gumbel-argmax over the derived uniforms gives ``jax.random.categorical``'s
    own draws for every key the step uses."""
    rng = np.random.default_rng(1)
    keyed = step["draws"]["posterior"] + step["draws"]["imagined_prior"] + [kd for h in step["draws"]["actions"] for kd in h]
    for k, shape in keyed:
        logits = rng.normal(size=shape).astype(np.float32) * 2
        want = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1, shape=shape[:-1]))
        got = np.argmax(logits - np.log(-np.log(_uniform(k, shape))), axis=-1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[1] for n in METRIC_NAMES])
def test_torch_train_step_metric_matches_jax(step, index, call):
    got, want = step["steps"][call]["port"]["metrics"][index], step["steps"][call]["jax"]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=METRIC_NAMES[index])


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
def test_torch_train_step_updated_parameters_match_jax(step, module, call):
    got, want = step["steps"][call]["port"]["params"][module], step["steps"][call]["jax"]["params"][module]
    before = step["steps"][call - 1]["jax"]["params"][module] if call else step["before"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=f"{module}.{name}")
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
    if module == "target_critic" and call == 0:
        # the first step copies the critic as it was before the step: the initial target
        for name, value in want.items():
            np.testing.assert_array_equal(value.numpy(), step["before"]["critic"][name].numpy())
    else:
        assert moved > 0, f"call {call} left every {module} parameter where it was"


@pytest.mark.parametrize("call", [0, 1])
def test_torch_train_step_moments_match_jax(step, call):
    port, jax_ = step["steps"][call]["port"]["moments"], step["steps"][call]["jax"]["moments"]
    for k in ("low", "high"):
        np.testing.assert_allclose(port[k], jax_[k], rtol=1e-5, atol=1e-8)
    assert jax_["high"] != 0.0
