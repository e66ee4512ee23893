"""One device-resident DreamerV3 dispatch of the port (``make_train_step(...,
ring=...)`` over ``data/ring.py``'s ``build_burst_train_step``) against the
JAX package's ``make_train_step(..., ring=...)`` (``build_burst_train_step``
on a one-device CPU mesh), at the tiny pixel+vector size of
``tests/test_torch_train_step.py`` (batch 2 x sequence 8, horizon 5), from
the same converted parameters, fresh optimizers and the same ring.

The dispatch: a 2-row packed upload (a regular row of both envs and a
ragged reset row of env 1) appended to a ring of 32 rows x 2 envs (env 0
full, env 1 filling), then 2 granted steps of a chunk of 3 (the third is
padding). The draws are JAX's, rebuilt from the dispatch key (``fold_in`` of
the device index, ``split`` per step, ``split(k, 3)`` into the env choices,
the window-start uniforms and the gradient step's key, whose noise splits
follow ``test_torch_train_step.py``) and fed to the port.

Tolerances: the ring after the append and each step's windows equal;
the ten metrics (the mean over the granted steps) within rtol 1e-4, atol
1e-5; the ``Moments`` state within rtol 1e-5 (as ``test_torch_train_step.py``
holds one host-sampled step); every parameter of the four modules within
atol 1e-6 after the two Adam steps, but for elements whose gradient was
within float32 noise of zero at a step (|g| below 1e-5 of its tensor's RMS
gradient, on the port): Adam moves those by lr * g / (|g| + eps), so a
gradient of 1e-7 made of terms of 0.1 moves 0.9 lr on one side and 0.99 lr on
the other. Those elements (1 of 8,192 in ``cnn_decoder.fc.weight`` here, at
8.1e-6) are held within 2 * lr, and there are at most 0.1 % of a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.data.ring import ring_append_rows as jax_ring_append_rows
from sheeprl_tpu.data.ring import ring_sample_windows as jax_ring_sample_windows
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.utils.burst import dreamer_ring_keys as jax_dreamer_ring_keys
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.data.ring import make_blob_layouts, pack_burst_blob, ring_sample_windows
from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_train import N_ACTIONS, tiny_configs
from tests.test_torch_train_step import _uniform

T, B, H = 8, 2, 5
CAP, E, CHUNK, GRANTED = 32, 2, 3, 2
EXTRA = [f"algo.per_rank_batch_size={B}", f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}"]


def _step_noise(step_key, stoch, discrete):
    """The uniforms the JAX gradient step's key gives (its ``k_dyn, k_img``
    splits), in the port's ``draw_noise`` layout."""
    k_dyn, k_img = jax.random.split(step_key)
    posterior = [_uniform(k, (B, stoch, discrete)).reshape(B, stoch * discrete) for k in jax.random.split(k_dyn, T)]
    k0, k_scan = jax.random.split(k_img)
    heads = [[_uniform(k, (T * B, N_ACTIONS))] for k in jax.random.split(k0, 1)]
    prior = []
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        prior.append(_uniform(k_prior, (T * B, stoch, discrete)).reshape(T * B, stoch * discrete))
        for i, kh in enumerate(jax.random.split(k_act, 1)):
            heads[i].append(_uniform(kh, (T * B, N_ACTIONS)))
    return {
        "posterior": torch.from_numpy(np.stack(posterior)),
        "imagined_prior": torch.from_numpy(np.stack(prior)),
        "actions": [torch.from_numpy(np.stack(h)) for h in heads],
    }


def _ring_and_blob(rng, keys):
    ring = {}
    for k, (shape, dtype) in keys.items():
        if np.dtype(dtype) == np.uint8:
            ring[k] = rng.integers(0, 256, (CAP, E) + tuple(shape)).astype(np.uint8)
        else:
            ring[k] = rng.normal(size=(CAP, E) + tuple(shape)).astype(np.float32)
    ring["actions"] = np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, (CAP, E))]
    ring["rewards"] = (rng.normal(size=(CAP, E, 1)) * 3).astype(np.float32)
    ring["terminated"] = (rng.random((CAP, E, 1)) < 0.05).astype(np.float32)
    ring["is_first"] = (rng.random((CAP, E, 1)) < 0.08).astype(np.float32)
    staged = {k: v[:2].copy() for k, v in ring.items()}
    for k in staged:
        rng.shuffle(staged[k])
    values = {
        **staged,
        "__mask__": np.array([[1, 1], [0, 1]], np.int32),
        "__pos__": np.array([9, 20], np.int32),
        "__valid_n__": np.array([CAP, 20], np.int32),
        "__validmask__": np.array([1.0] * GRANTED + [0.0] * (CHUNK - GRANTED), np.float32),
    }
    return ring, values


@pytest.fixture(scope="module")
def dispatch():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    before = jax.tree.map(lambda a: np.array(a), params)
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": jax_build_optimizer(cfg.algo.actor.optimizer, max_grad_norm=cfg.algo.actor.clip_gradients),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    opts = {name: txs[name].init(params[p]) for name, p in
            (("world", "world_model"), ("actor", "actor"), ("critic", "critic"))}
    jax_keys = jax_dreamer_ring_keys(obs_space, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    port_keys = dreamer_ring_keys(port_cfg.spaces.obs, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": CHUNK, "seq_len": T, "batch_size": B,
            "stage_buckets": (1, 2), "stage_max": 2}
    ring, values = _ring_and_blob(np.random.default_rng(0), port_keys)
    key = jax.random.PRNGKey(21)

    burst = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs,
                                ring={**spec, "ring_keys": jax_keys})
    blob = jax_pack(jax_make_blob_layouts(jax_keys, E, CHUNK, (1, 2))[2], {**values, "__key__": np.asarray(key, np.uint32)})
    (params, opts, jax_moments, cum), jax_rb, jax_metrics = burst(
        (params, opts, jax_init_moments(), jnp.int32(0)), {k: jnp.asarray(v) for k, v in ring.items()}, jnp.asarray(blob)
    )

    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    _, new_pos, new_valid = jax_ring_append_rows(jnp.asarray(values["__pos__"]), jnp.asarray(values["__valid_n__"]),
                                                 jnp.asarray(values["__mask__"]), CAP)
    env_idx, u, noise, windows = [], [], [], []
    for k in jax.random.split(jax.random.fold_in(key, 0), CHUNK)[:GRANTED]:
        k_env, k_start, k_grad = jax.random.split(k, 3)
        env_idx.append(np.array(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.array(jax.random.uniform(k_start, (B,))))
        noise.append(_step_noise(k_grad, S, D))
        windows.append(np.asarray(jax_ring_sample_windows(k_start, jnp.asarray(env_idx[-1]), new_pos, new_valid, CAP, T)))

    wm, port_actor, port_critic, port_target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(before))
    optimizers = make_optimizers(port_cfg, wm, port_actor, port_critic)
    grads = {name: [] for name in optimizers}  # each step's gradients, as each optimizer gets them
    for name, opt in optimizers.items():
        opt.step = lambda g, step=opt.step, out=grads[name]: (out.append([x.clone() for x in g]), step(g))[1]
    port_burst = make_train_step(wm, port_actor, port_critic, port_target, optimizers, port_cfg,
                                 ring={**spec, "ring_keys": port_keys})
    rb = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    draws = {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)), "noise": noise}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (port_moments, port_cum), port_rb, port_metrics = port_burst(
            (init_moments(), 0), rb, pack_burst_blob(make_blob_layouts(port_keys, E, CHUNK, (1, 2))[2], values),
            None, draws,
        )
    finally:
        torch.set_num_threads(n_threads)
    port_windows = [ring_sample_windows(draws["u"][g], draws["env"][g], torch.from_numpy(np.array(new_pos)),
                                        torch.from_numpy(np.array(new_valid)), CAP, T).numpy() for g in range(GRANTED)]
    port_modules = (("world_model", wm), ("actor", port_actor), ("critic", port_critic), ("target_critic", port_target))
    noise_level = {}  # module -> parameter -> elements whose gradient was within float32 noise of zero at a step
    for module, opt in (("world_model", "world"), ("actor", "actor"), ("critic", "critic")):
        names = [n for n, _ in dict(port_modules)[module].named_parameters()]
        for i, n in enumerate(names):
            flags = [(g[i].abs() < 1e-5 * g[i].pow(2).mean().sqrt()).numpy() for g in grads[opt]]
            noise_level.setdefault(module, {})[n] = np.logical_or.reduce(flags)
    return {
        "jax": {"rb": {k: np.asarray(v) for k, v in jax_rb.items()}, "cum": int(cum), "windows": windows,
                "metrics": [float(m) for m in jax_metrics], "moments": {k: float(v) for k, v in jax_moments.items()},
                "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, params))},
        "port": {"rb": {k: v.numpy() for k, v in port_rb.items()}, "cum": port_cum, "windows": port_windows,
                 "metrics": port_metrics.tolist(), "moments": {k: float(v) for k, v in port_moments.items()},
                 "params": {name: m.state_dict() for name, m in port_modules}},
        "before": dreamer_v3_state_from_jax(before),
        "ring": ring,
        "noise_level": noise_level,
        "lr": {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5},
    }


def test_torch_rssm_resident_dispatch_appends_the_ring_like_jax(dispatch):
    for k, want in dispatch["jax"]["rb"].items():
        np.testing.assert_array_equal(dispatch["port"]["rb"][k], want, err_msg=k)
    changed = [int((dispatch["jax"]["rb"]["rewards"][:, e] != dispatch["ring"]["rewards"][:, e]).any(-1).sum())
               for e in range(E)]
    assert changed == [1, 2]  # env 0 took the regular row, env 1 that and its reset row


def test_torch_rssm_resident_dispatch_draws_jax_windows(dispatch):
    assert len(dispatch["port"]["windows"]) == GRANTED
    for got, want in zip(dispatch["port"]["windows"], dispatch["jax"]["windows"]):
        np.testing.assert_array_equal(got, want)
    assert dispatch["port"]["cum"] == dispatch["jax"]["cum"] == GRANTED


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[1] for n in METRIC_NAMES])
def test_torch_rssm_resident_dispatch_metric_matches_jax(dispatch, index):
    got, want = dispatch["port"]["metrics"][index], dispatch["jax"]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=METRIC_NAMES[index])


@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
def test_torch_rssm_resident_dispatch_parameters_match_jax(dispatch, module):
    got, want = dispatch["port"]["params"][module], dispatch["jax"]["params"][module]
    before = dispatch["before"][module]
    noise = dispatch["noise_level"].get(module, {})
    lr = dispatch["lr"].get(module, 8e-5)
    assert set(got) == set(want)
    moved = flagged = total = 0
    for name, value in want.items():
        diff = np.abs(got[name].numpy() - value.numpy())
        free = noise.get(name, np.zeros(diff.shape, bool))
        assert (diff[~free] <= 1e-6).all(), f"{module}.{name}: {diff[~free].max()}"
        assert (diff[free] <= 2 * lr).all(), f"{module}.{name}"
        moved += int(not np.array_equal(value.numpy(), before[name].numpy()))
        flagged, total = flagged + int(free.sum()), total + diff.size
    assert flagged <= 1e-3 * total
    assert moved > 0, f"the dispatch left every {module} parameter where it was"


def test_torch_rssm_resident_dispatch_moments_match_jax(dispatch):
    port, jax_ = dispatch["port"]["moments"], dispatch["jax"]["moments"]
    for k in ("low", "high"):
        np.testing.assert_allclose(port[k], jax_[k], rtol=1e-5, atol=1e-8)

