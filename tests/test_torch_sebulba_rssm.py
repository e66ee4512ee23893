"""``dreamer_sebulba``'s programs (``algos/dreamer_v3/dreamer_sebulba.py``)
against the JAX package's, on the CPU, at the tiny pixel+vector size of
``tests/test_torch_rssm_resident_dispatch.py`` (batch 2 x sequence 8,
horizon 5), from the same converted parameters.

- ``player_subset`` publishes exactly JAX's leaves (encoder, recurrent,
  representation and transition models, the initial recurrent state, the
  actor), sharing the learner's tensors.
- The act step against JAX's ``make_act_step`` over four steps of 3 rows,
  with ``is_first`` on every row, on none and on one: each step from JAX's
  carries (teacher-forced), fed the uniforms JAX's key gives (``split`` into
  the posterior's and the actor's keys). The recurrent state within atol
  1e-5 and the representation logits within atol 1e-4, the serving parity
  tests' tolerances (``tests/test_torch_rssm_serve.py``); the posterior and
  action draws the same one-hots.
- One append of an actor's blob at env columns 2-3 (two regular rows and a
  ragged reset row) and one guarded append-free dispatch of 2 granted steps
  of 3 against JAX's ``build_seq_append_step`` and ``make_train_step(...,
  ring={"decoupled": True}, guard=True)``, with JAX's draws rebuilt from the
  ring key (``split``, ``fold_in`` of the device index, ``split(G)``,
  ``split(k, 3)``). Tolerances, those of the port's resident dispatch parity
  test: the ring and heads after the append bit-equal; the eleven metrics
  (the ten losses and the skipped share) within rtol 1e-4, atol 1e-5; the
  ``Moments`` state within rtol 1e-5; every parameter within atol 1e-6 but
  for elements whose gradient was within float32 noise of zero at a step
  (below 1e-5 of its tensor's RMS gradient), held within 2 * lr; at most
  0.1 % of a module's elements may need that excuse (the tiny actor has
  such near-zero gradients on 8 of its 307 elements, none of them past
  1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_sebulba import make_act_step as jax_make_act_step
from sheeprl_tpu.algos.dreamer_v3.dreamer_sebulba import player_subset as jax_player_subset
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.data.ring import build_seq_append_step as jax_build_seq_append_step
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.data.ring import ring_sample_windows as jax_ring_sample_windows
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.utils.burst import dreamer_ring_keys as jax_dreamer_ring_keys
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import make_act_step, player_subset
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, prepare_obs
from sheeprl_tpu_torch.data.ring import pack_burst_blob, ring_sample_windows
from sheeprl_tpu_torch.replay import AsyncSequenceRing, DeviceReplayState
from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_resident_dispatch import EXTRA, B, T, _step_noise
from tests.test_torch_rssm_train import N_ACTIONS, _same_draw, _uniform, tiny_configs

CAP, LOCAL, ACTORS, STAGE, CHUNK, GRANTED = 32, 2, 2, 4, 3, 2
E = LOCAL * ACTORS
OFFSET = LOCAL  # the second actor's columns


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    before = jax.tree.map(lambda a: np.array(a), params)
    return {"cfg": cfg, "port_cfg": port_cfg, "obs_space": obs_space, "fabric": fabric,
            "jax": (world_model, actor, critic, params), "before": before}


def test_torch_sebulba_rssm_player_subset_holds_jax_leaves(agents):
    wm, actor, critic, target = build_training_agent(agents["port_cfg"], "cpu",
                                                     dreamer_v3_state_from_jax(agents["before"]))
    sub = player_subset(wm, actor)
    want = dreamer_v3_state_from_jax(jax.tree.map(np.asarray, jax_player_subset(agents["before"])))
    got = sub.state_dict()
    assert set(got) == {f"world_model.{k}" for k in want["world_model"]} | {f"actor.{k}" for k in want["actor"]}
    for name, tree in want.items():
        for k, v in tree.items():
            assert torch.equal(got[f"{name}.{k}"], v), k
    # the learner's own tensors: a copy into the snapshot reads the live weights
    assert sub.world_model.initial_recurrent_state is wm.initial_recurrent_state
    assert {id(p) for p in sub.parameters()} <= {id(p) for p in (*wm.parameters(), *actor.parameters())}
    assert not any(k.split(".")[1] in ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model") for k in got)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_torch_sebulba_rssm_act_step_matches_jax(agents):
    world_model, actor, _, params = agents["jax"]
    cfg = agents["port_cfg"]
    wm, port_actor, _, _ = build_training_agent(cfg, "cpu", dreamer_v3_state_from_jax(agents["before"]))
    agent = player_subset(wm, port_actor)
    act = make_act_step(wm, port_actor)
    subset = jax_player_subset(params)
    wmp = subset["world_model"]
    jax_act = jax.jit(jax_make_act_step(world_model, actor))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    n, rec_size = 3, int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    carry = (np.zeros((n, N_ACTIONS), np.float32), np.zeros((n, rec_size), np.float32), np.zeros((n, S * D), np.float32))
    rng = np.random.default_rng(11)
    firsts = [np.ones((n, 1)), np.zeros((n, 1)), np.array([[0.0], [1.0], [0.0]]), np.zeros((n, 1))]
    for t, first in enumerate(firsts):
        first = first.astype(np.float32)
        raw = {"rgb": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
               "state": rng.normal(size=(n, 10)).astype(np.float32) * 3}
        obs = prepare_obs(raw, cnn_keys=["rgb"], num_envs=n)
        key = jax.random.PRNGKey(100 + t)
        acts, cat, rec, stoch = jax_act(subset, {k: jnp.asarray(v) for k, v in obs.items()},
                                        *(jnp.asarray(c) for c in carry), jnp.asarray(first), key)
        k_repr, k_act = jax.random.split(key)
        noise = {"posterior": _t(_uniform(k_repr, (n, S, D))).reshape(n, S * D),
                 "actions": [_t(_uniform(k, (n, N_ACTIONS))) for k in jax.random.split(k_act, 1)]}
        with torch.no_grad():
            p_acts, p_cat, p_rec, p_stoch = act(agent, {k: torch.from_numpy(v) for k, v in obs.items()},
                                                *(_t(c) for c in carry), _t(first), noise)
            port_logits = wm.representation(p_rec, wm.encoder({k: torch.from_numpy(v) for k, v in obs.items()}))
        emb = world_model.encoder.apply(wmp["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
        jax_logits, _ = world_model.rssm._representation(wmp, rec, emb, jax.random.PRNGKey(0))
        assert p_rec.dtype == p_stoch.dtype == p_cat.dtype == torch.float32
        np.testing.assert_allclose(p_rec.numpy(), np.asarray(rec), atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(port_logits.numpy(), np.asarray(jax_logits), atol=1e-4, err_msg=f"step {t}")
        _same_draw(p_stoch, stoch)
        _same_draw(p_cat, cat)
        _same_draw(p_acts[0], acts[0])
        carry = (np.asarray(cat), np.asarray(rec), np.asarray(stoch))  # teacher-forced: JAX's carries go on


def _ring(rng, keys):
    storage = {}
    for k, (shape, dtype) in keys.items():
        if np.dtype(dtype) == np.uint8:
            storage[k] = rng.integers(0, 256, (CAP, E) + tuple(shape)).astype(np.uint8)
        else:
            storage[k] = rng.normal(size=(CAP, E) + tuple(shape)).astype(np.float32)
    storage["actions"] = np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, (CAP, E))]
    storage["rewards"] = (rng.normal(size=(CAP, E, 1)) * 3).astype(np.float32)
    storage["terminated"] = (rng.random((CAP, E, 1)) < 0.05).astype(np.float32)
    storage["is_first"] = (rng.random((CAP, E, 1)) < 0.08).astype(np.float32)
    # columns 0 and 3 full, 1 and 2 filling
    return storage, np.array([9, 20, 13, 30], np.int32), np.array([CAP, 20, 13, CAP], np.int32)


def _rows(rng, keys):
    def row():
        out = {k: rng.normal(size=(LOCAL,) + tuple(s)).astype(np.float32) for k, (s, _) in keys.items()}
        out["rgb"] = rng.integers(0, 256, (LOCAL,) + tuple(keys["rgb"][0])).astype(np.uint8)
        out["actions"] = np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, LOCAL)]
        return out

    return [(row(), np.ones(LOCAL, np.int32)), (row(), np.ones(LOCAL, np.int32)), (row(), np.array([0, 1], np.int32))]


@pytest.fixture(scope="module")
def dispatch(agents):
    cfg, port_cfg, obs_space, fabric = agents["cfg"], agents["port_cfg"], agents["obs_space"], agents["fabric"]
    world_model, actor, critic, params = agents["jax"]
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": jax_build_optimizer(cfg.algo.actor.optimizer, max_grad_norm=cfg.algo.actor.clip_gradients),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    opts = {name: txs[name].init(params[p]) for name, p in
            (("world", "world_model"), ("actor", "actor"), ("critic", "critic"))}
    jax_keys = jax_dreamer_ring_keys(obs_space, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    port_keys = dreamer_ring_keys(port_cfg.spaces.obs, ["rgb"], ["state"], (N_ACTIONS,), with_is_first=True)
    rng = np.random.default_rng(0)
    storage, pos, valid = _ring(rng, port_keys)
    rows = _rows(rng, port_keys)
    key = jax.random.PRNGKey(33)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": CHUNK, "seq_len": T, "batch_size": B, "decoupled": True}
    validmask = np.array([1.0] * GRANTED + [0.0] * (CHUNK - GRANTED), np.float32)

    # JAX: the donated append, then the guarded append-free dispatch
    ring = AsyncSequenceRing(port_keys, CAP, E, LOCAL, T, STAGE, seed=3)
    blob = ring.pack_rows(rows, OFFSET)
    append_fn, layout = jax_build_seq_append_step(fabric.mesh, jax_keys, CAP, E, LOCAL, STAGE)
    state = append_fn({"storage": {k: jnp.asarray(v) for k, v in storage.items()}, "pos": jnp.asarray(pos),
                       "valid": jnp.asarray(valid), "key": jnp.array(key)}, jnp.asarray(blob.numpy()))  # donated
    train_fn, ctl_layout = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs,
                                               ring=spec, guard=True)
    (p_new, _, jax_moments, cum), _, jax_metrics = train_fn(
        (params, opts, jax_init_moments(), jnp.int32(0)), state,
        jnp.asarray(jax_pack(ctl_layout, {"__validmask__": validmask})))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    _, k_dispatch = jax.random.split(key)
    env_idx, u, noise, windows = [], [], [], []
    for k in jax.random.split(jax.random.fold_in(k_dispatch, 0), CHUNK)[:GRANTED]:
        k_env, k_start, k_grad = jax.random.split(k, 3)
        env_idx.append(np.array(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.array(jax.random.uniform(k_start, (B,))))
        noise.append(_step_noise(k_grad, S, D))
        windows.append(np.asarray(jax_ring_sample_windows(k_start, jnp.asarray(env_idx[-1]), state["pos"],
                                                          state["valid"], CAP, T)))

    # the port: the same ring, the same append, the same dispatch on JAX's draws
    wm, port_actor, port_critic, port_target = build_training_agent(port_cfg, "cpu",
                                                                    dreamer_v3_state_from_jax(agents["before"]))
    optimizers = make_optimizers(port_cfg, wm, port_actor, port_critic)
    grads = {name: [] for name in optimizers}  # each step's gradients, as each optimizer gets them
    for name, opt in optimizers.items():
        opt.step = lambda g, step=opt.step, out=grads[name]: (out.append([x.clone() for x in g]), step(g))[1]
    arrays = {f"storage/{k}": torch.from_numpy(v.copy()) for k, v in storage.items()}
    arrays.update(pos=torch.from_numpy(pos), valid=torch.from_numpy(valid))
    ring.load_state_dict(DeviceReplayState("sequence", arrays, {"capacity": CAP, "n_envs": E, "seq_len": T}))
    counts = np.zeros(E, np.int64)
    counts[OFFSET:OFFSET + LOCAL] = sum(m for _, m in rows)
    ring.append(blob, OFFSET)
    ring.note_append(counts, blob.numel())
    port_train, port_ctl = make_train_step(wm, port_actor, port_critic, port_target, optimizers, port_cfg, ring=spec,
                                           guard=True)
    draws = {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)), "noise": noise}
    (port_moments, port_cum), port_metrics = port_train(
        (init_moments(), 0), ring.state, pack_burst_blob(port_ctl, {"__validmask__": validmask}), ring.host_valid,
        None, draws)
    port_windows = [ring_sample_windows(draws["u"][g], draws["env"][g], ring.state["pos"], ring.state["valid"], CAP,
                                        T).numpy() for g in range(GRANTED)]
    port_modules = (("world_model", wm), ("actor", port_actor), ("critic", port_critic), ("target_critic", port_target))
    noise_level = {}
    for module, opt in (("world_model", "world"), ("actor", "actor"), ("critic", "critic")):
        names = [n for n, _ in dict(port_modules)[module].named_parameters()]
        for i, n in enumerate(names):
            flags = [(g[i].abs() < 1e-5 * g[i].pow(2).mean().sqrt()).numpy() for g in grads[opt]]
            noise_level.setdefault(module, {})[n] = np.logical_or.reduce(flags)
    return {
        "jax": {"storage": {k: np.asarray(v) for k, v in state["storage"].items()}, "pos": np.asarray(state["pos"]),
                "valid": np.asarray(state["valid"]), "cum": int(cum), "windows": windows,
                "metrics": [float(m) for m in jax_metrics],
                "moments": {k: float(v) for k, v in jax_moments.items()},
                "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, p_new))},
        "port": {"storage": {k: v.numpy() for k, v in ring.state["storage"].items()},
                 "pos": ring.state["pos"].numpy(), "valid": ring.state["valid"].numpy(), "host_valid": ring.host_valid,
                 "cum": int(port_cum), "windows": port_windows, "metrics": port_metrics.tolist(),
                 "moments": {k: float(v) for k, v in port_moments.items()},
                 "params": {name: m.state_dict() for name, m in port_modules}},
        "before": dreamer_v3_state_from_jax(agents["before"]),
        "storage": storage,
        "noise_level": noise_level,
        "lr": {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5},
    }


def test_torch_sebulba_rssm_append_matches_jax(dispatch):
    for k, want in dispatch["jax"]["storage"].items():
        np.testing.assert_array_equal(dispatch["port"]["storage"][k], want, err_msg=k)
    for h in ("pos", "valid"):
        np.testing.assert_array_equal(dispatch["port"][h], dispatch["jax"][h], err_msg=h)
    np.testing.assert_array_equal(dispatch["port"]["host_valid"], dispatch["jax"]["valid"])
    changed = [int((dispatch["jax"]["storage"]["rewards"][:, e] != dispatch["storage"]["rewards"][:, e]).any(-1).sum())
               for e in range(E)]
    assert changed == [0, 0, 2, 3]  # the actor's columns only; its second env took the reset row too


def test_torch_sebulba_rssm_dispatch_draws_jax_windows(dispatch):
    for got, want in zip(dispatch["port"]["windows"], dispatch["jax"]["windows"]):
        np.testing.assert_array_equal(got, want)
    assert dispatch["port"]["cum"] == dispatch["jax"]["cum"] == GRANTED


NAMES = METRIC_NAMES + ("Fault/skipped_fraction",)


@pytest.mark.parametrize("index", range(len(NAMES)), ids=[n.split("/")[1] for n in NAMES])
def test_torch_sebulba_rssm_dispatch_metric_matches_jax(dispatch, index):
    got, want = dispatch["port"]["metrics"][index], dispatch["jax"]["metrics"][index]
    assert len(dispatch["port"]["metrics"]) == len(NAMES) and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=NAMES[index])


@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
def test_torch_sebulba_rssm_dispatch_parameters_match_jax(dispatch, module):
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
        flagged, total = flagged + int((free & (diff > 1e-6)).sum()), total + diff.size
    assert flagged <= 1e-3 * total
    assert moved > 0, f"the dispatch left every {module} parameter where it was"


def test_torch_sebulba_rssm_dispatch_moments_match_jax(dispatch):
    for k in ("low", "high"):
        np.testing.assert_allclose(dispatch["port"]["moments"][k], dispatch["jax"]["moments"][k], rtol=1e-5, atol=1e-8)
