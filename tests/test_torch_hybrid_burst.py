"""The hybrid player's DreamerV3 pieces against the JAX package's, on the
CPU, at the tiny pixel+vector size of ``tests/test_torch_train_step.py``
(batch 2 x sequence 8, horizon 5), from the same converted parameters.

- ``HostSnapshot``: JAX's ``pull`` of the player subset (``dreamer_v3.py``'s
  ``_player_subset``: encoder, recurrent, representation and transition
  models, the initial recurrent state and the actor) and the port's pull
  into the CPU copy of ``dreamer_sebulba.player_subset`` give the same
  float32 values after the bf16 round trip, bit for bit, once converted with
  ``utils/convert.py``.
- The hybrid burst: ``make_train_step(..., ring=...)`` at the harness's ring
  spec (``train_every`` 2 on 2 envs: grad_chunk 4, the buckets of
  ``dreamer_stage_sizes``), one 5-row flush into the 6-row bucket (regular
  rows and ragged reset rows), 2 granted steps of the 4. JAX's draws, rebuilt
  from the burst key as ``tests/test_torch_rssm_resident_dispatch.py``
  rebuilds them, are injected into the port. Tolerances, the resident
  dispatch's: the ring after the append bit for bit; the ten mean metrics
  within rtol 1e-4, atol 1e-5; every parameter within 1e-6 but for elements
  whose gradient was within float32 noise of zero at a step, held within
  2 lr (at most 0.1 % of a module).
"""

import copy

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
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.utils.burst import HostSnapshot as JaxHostSnapshot
from sheeprl_tpu.utils.burst import dreamer_ring_keys as jax_dreamer_ring_keys
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import player_subset
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.data.ring import effective_stage_buckets, make_blob_layouts, pack_burst_blob
from sheeprl_tpu_torch.utils.burst import HostSnapshot, dreamer_ring_keys, dreamer_stage_sizes
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_resident_dispatch import CAP, EXTRA, B, E, T, _step_noise
from tests.test_torch_rssm_train import N_ACTIONS, tiny_configs

TRAIN_EVERY, GRANTED, ROWS = 2, 2, 5


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    return {"cfg": cfg, "port_cfg": port_cfg, "obs_space": obs_space, "fabric": fabric,
            "jax": (world_model, actor, critic), "params": params,
            "before": jax.tree.map(lambda a: np.array(a), params)}


def _jax_player_subset(p):
    wm = p["world_model"]
    return {
        "world_model": {k: wm[k] for k in ("encoder", "recurrent_model", "representation_model", "transition_model",
                                           "initial_recurrent_state")},
        "actor": p["actor"],
    }


def test_torch_hybrid_burst_snapshot_pull_matches_jax(agents):
    before = agents["before"]
    pulled = jax.tree.map(np.asarray, JaxHostSnapshot(_jax_player_subset, agents["params"]).pull(agents["params"]))
    full = {**before, "world_model": {**before["world_model"], **pulled["world_model"]}, "actor": pulled["actor"]}
    want = dreamer_v3_state_from_jax(full)

    wm, actor, _, _ = build_training_agent(agents["port_cfg"], "cpu", dreamer_v3_state_from_jax(before))
    card = player_subset(wm, actor)
    host = copy.deepcopy(card)
    with torch.no_grad():
        for t in host.parameters():
            t.zero_()
    snap = HostSnapshot([*card.parameters(), *card.buffers()], [*host.parameters(), *host.buffers()], torch.bfloat16)
    snap.pull()
    got = {"world_model": host.world_model.state_dict(), "actor": host.actor.state_dict()}
    checked = rounded = 0
    for module in ("world_model", "actor"):
        for name, value in got[module].items():
            ref = want[module][name]
            assert value.dtype == torch.float32
            assert torch.equal(value, ref), f"{module}.{name}"
            checked += 1
            rounded += int(not torch.equal(ref, dreamer_v3_state_from_jax(before)[module][name]))
    assert checked > 10 and rounded > 0  # the bf16 round trip moved values, identically on both sides
    assert snap.nbytes == 2 * sum(t.numel() for t in card.parameters())


def _values(rng, keys, chunk):
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
    bucket = 6
    staged = {k: np.zeros((bucket,) + v.shape[1:], v.dtype) for k, v in ring.items()}
    for k in staged:
        staged[k][:ROWS] = ring[k][rng.permutation(CAP)[:ROWS]]
    mask = np.zeros((bucket, E), np.int32)
    mask[:ROWS] = [[1, 1], [0, 1], [1, 1], [1, 0], [1, 1]]
    values = {
        **staged,
        "__mask__": mask,
        "__pos__": np.array([9, 20], np.int32),
        "__valid_n__": np.array([CAP, 20], np.int32),
        "__validmask__": np.array([1.0] * GRANTED + [0.0] * (chunk - GRANTED), np.float32),
    }
    return ring, values, bucket


@pytest.fixture(scope="module")
def burst(agents):
    cfg, port_cfg, obs_space, fabric = agents["cfg"], agents["port_cfg"], agents["obs_space"], agents["fabric"]
    world_model, actor, critic = agents["jax"]
    params, before = agents["params"], agents["before"]
    chunk = max(1, int(round(float(cfg.algo.replay_ratio) * E * TRAIN_EVERY)))
    stage_max, stage_buckets = dreamer_stage_sizes(TRAIN_EVERY, E, CAP)
    buckets = effective_stage_buckets(stage_buckets, stage_max)
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": jax_build_optimizer(cfg.algo.actor.optimizer, max_grad_norm=cfg.algo.actor.clip_gradients),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    opts = {name: txs[name].init(params[p]) for name, p in
            (("world", "world_model"), ("actor", "actor"), ("critic", "critic"))}
    jax_keys = jax_dreamer_ring_keys(obs_space, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    port_keys = dreamer_ring_keys(port_cfg.spaces.obs, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": chunk, "seq_len": T, "batch_size": B,
            "stage_buckets": buckets, "stage_max": stage_max}
    ring, values, bucket = _values(np.random.default_rng(3), port_keys, chunk)
    key = jax.random.PRNGKey(33)

    jax_burst = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs,
                                    ring={**spec, "ring_keys": jax_keys})
    blob = jax_pack(jax_make_blob_layouts(jax_keys, E, chunk, buckets)[bucket],
                    {**values, "__key__": np.asarray(key, np.uint32)})
    (jparams, _, jax_moments, cum), jax_rb, jax_metrics = jax_burst(
        (params, opts, jax_init_moments(), jnp.int32(0)), {k: jnp.asarray(v) for k, v in ring.items()},
        jnp.asarray(blob),
    )
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    env_idx, u, noise = [], [], []
    for k in jax.random.split(jax.random.fold_in(key, 0), chunk)[:GRANTED]:
        k_env, k_start, k_grad = jax.random.split(k, 3)
        env_idx.append(np.array(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.array(jax.random.uniform(k_start, (B,))))
        noise.append(_step_noise(k_grad, S, D))

    wm, port_actor, port_critic, port_target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(before))
    optimizers = make_optimizers(port_cfg, wm, port_actor, port_critic)
    grads = {name: [] for name in optimizers}
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
            (init_moments(), 0), rb, pack_burst_blob(make_blob_layouts(port_keys, E, chunk, buckets)[bucket], values),
            None, draws,
        )
    finally:
        torch.set_num_threads(n_threads)
    port_modules = (("world_model", wm), ("actor", port_actor), ("critic", port_critic), ("target_critic", port_target))
    noise_level = {}
    for module, opt in (("world_model", "world"), ("actor", "actor"), ("critic", "critic")):
        names = [n for n, _ in dict(port_modules)[module].named_parameters()]
        for i, n in enumerate(names):
            flags = [(g[i].abs() < 1e-5 * g[i].pow(2).mean().sqrt()).numpy() for g in grads[opt]]
            noise_level.setdefault(module, {})[n] = np.logical_or.reduce(flags)
    return {
        "chunk": chunk, "buckets": buckets,
        "jax": {"rb": {k: np.asarray(v) for k, v in jax_rb.items()}, "cum": int(cum),
                "metrics": [float(m) for m in jax_metrics],
                "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, jparams))},
        "port": {"rb": {k: v.numpy() for k, v in port_rb.items()}, "cum": int(port_cum),
                 "metrics": port_metrics.tolist(), "params": {name: m.state_dict() for name, m in port_modules}},
        "before": dreamer_v3_state_from_jax(before), "ring": ring, "noise_level": noise_level,
        "lr": {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5},
    }


def test_torch_hybrid_burst_spec_is_the_harness_spec(burst):
    assert burst["chunk"] == 4 and burst["buckets"] == (6, 8, 12)


def test_torch_hybrid_burst_appends_the_ring_like_jax(burst):
    for k, want in burst["jax"]["rb"].items():
        np.testing.assert_array_equal(burst["port"]["rb"][k], want, err_msg=k)
    changed = [int((burst["jax"]["rb"]["rewards"][:, e] != burst["ring"]["rewards"][:, e]).any(-1).sum())
               for e in range(E)]
    assert changed == [4, 4]  # env 0 took 4 of the 5 rows, env 1 took 4
    assert burst["port"]["cum"] == burst["jax"]["cum"] == GRANTED


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[1] for n in METRIC_NAMES])
def test_torch_hybrid_burst_metric_matches_jax(burst, index):
    got, want = burst["port"]["metrics"][index], burst["jax"]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=METRIC_NAMES[index])


@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
def test_torch_hybrid_burst_parameters_match_jax(burst, module):
    got, want = burst["port"]["params"][module], burst["jax"]["params"][module]
    before = burst["before"][module]
    noise = burst["noise_level"].get(module, {})
    lr = burst["lr"].get(module, 8e-5)
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
    assert moved > 0, f"the burst left every {module} parameter where it was"
