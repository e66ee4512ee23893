"""One SAC update of the port against the JAX package's, on the CPU.

Three updates, each at a small size of the ``exp=sac`` recipe (hidden 32,
batch 16, 2 critics, Pendulum's 3 observations and 1 torque in [-2, 2]):

- the device-resident dispatch with PER (``make_resident_train_step``):
  a ring of capacity 64 x 2 envs holding 23 rows with random priorities and
  ``max_p`` 3, one staged row appended (its 2 fresh leaves at ``max_p``),
  then 2 gradient steps, each drawing through the sum-tree
  (``sumtree_sample``, beta 0.55), weighting the critic's errors by the
  normalized IS weights and writing |TD| priorities back;
- the same dispatch with uniform sampling (the JAX package's pre-gathered
  variant);
- the host path's ``make_train_step`` on a ``(2, 16)`` sample.

Both sides start from the same flax weights (``sac_state_from_jax``), a
fresh Adam each and the same ring. The port is fed JAX's own draws, rebuilt
from the dispatch's key splits (``sac.py:409``: ``split`` of the ring key,
``fold_in`` of the device index, one key per step split in four; the
uniform variant's ``sac.py:549-553``; the host path's ``fold_in`` and
``split``).

Tolerances (float32 on both sides, sums in another order): the three mean
losses within rtol 1e-5 (atol 1e-6); every parameter, the sum-tree and
``max_p`` within 1e-5; the ring's storage exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium as gym
from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.sac import make_resident_train_step as jax_resident_step
from sheeprl_tpu.algos.sac.sac import make_train_step as jax_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.replay import DeviceReplayBuffer as JaxDeviceReplayBuffer
from sheeprl_tpu.replay import sumtree as jst
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_optimizers, make_resident_train_step, make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax

HIDDEN, BATCH, CAP, N_ENVS, G, FILLED = 32, 16, 64, 2, 2, 23
OBS, ACT = 3, 1
TOL = dict(rtol=1e-5, atol=1e-6)
SPECS = {
    "observations": ((OBS,), np.float32),
    "next_observations": ((OBS,), np.float32),
    "actions": ((ACT,), np.float32),
    "rewards": ((1,), np.float32),
    "terminated": ((1,), np.float32),
}
ACTION_SPACE = {"shape": [ACT], "low": [-2.0], "high": [2.0]}
OVERRIDES = [f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={BATCH}", f"env.num_envs={N_ENVS}"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(rng, rows=1):
    """``rows`` transitions of every env, ``(rows, N_ENVS, ...)``."""
    return {
        "observations": rng.normal(size=(rows, N_ENVS, OBS)).astype(np.float32),
        "next_observations": rng.normal(size=(rows, N_ENVS, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(rows, N_ENVS, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(rows, N_ENVS, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(rows, N_ENVS, 1)) < 0.2).astype(np.float32),
    }


def _jax_setup(prioritized):
    cfg = compose(["exp=sac"] + OVERRIDES)
    fabric = Fabric(devices=1, accelerator="cpu")
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32)
    agent, params, _ = jax_build_agent(fabric, cfg, obs_space, act_space)
    txs = [jax_build_optimizer(cfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")]
    opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
    return cfg, fabric, agent, params, txs, opts


def _port_setup(params):
    cfg = apply_overrides(preset("sac"), OVERRIDES + [f"algo.actor.hidden_size={HIDDEN}", f"algo.critic.hidden_size={HIDDEN}"])
    agent, _ = build_agent(cfg, OBS, ACTION_SPACE, "cpu", sac_state_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, agent, make_optimizers(cfg, agent)


def _filled_jax_ring(fabric, prioritized, rng):
    drb = JaxDeviceReplayBuffer(
        fabric, {k: (s, jnp.float32) for k, (s, _) in SPECS.items()}, CAP, N_ENVS, prioritized=prioritized,
        per_alpha=0.6, per_eps=1e-6,
        extra_spec=[("__flags__", (G,), np.float32), ("__valid__", (G,), np.float32), ("__beta__", (), np.float32)],
        seed=29,
    )
    append = drb.make_append_step(donate=False)
    for _ in range(FILLED):
        drb.state = append(drb.state, jnp.asarray(drb.pack_rows([{k: v[0] for k, v in _row(rng).items()}])))
        drb.note_append(1)
    if prioritized:  # random priorities on the filled leaves, a raised max_p
        leaves = np.arange(FILLED * N_ENVS)
        prios = rng.uniform(0.05, 2.0, size=leaves.shape).astype(np.float32)
        drb.state["tree"] = jst.update(drb.state["tree"], jnp.asarray(leaves), jnp.asarray(prios))
        drb.state["max_p"] = jnp.float32(3.0)
    return drb


def _port_ring(jax_drb, prioritized):
    """The port's ring holding the JAX ring's contents."""
    snap = jax_drb.state_dict()
    drb = DeviceReplayBuffer(SPECS, CAP, N_ENVS, prioritized=prioritized, per_alpha=0.6, per_eps=1e-6, seed=29)
    arrays = {k: torch.from_numpy(np.array(v)) for k, v in snap.arrays.items() if k != "key"}
    arrays["key"] = drb.generator.get_state()
    drb.load_state_dict(DeviceReplayState("uniform", arrays, dict(snap.meta)))
    return drb


def _jax_resident_draws(key, prioritized, valid):
    """The random numbers JAX's resident dispatch draws from its ring key."""
    _, sub = jax.random.split(key)
    if prioritized:
        out = {"u": [], "next": [], "actor": []}
        for k in jax.random.split(jax.random.fold_in(sub, 0), G):
            k_a, _k_b, k_next, k_actor = jax.random.split(k, 4)
            out["u"].append(jax.random.uniform(k_a, (BATCH,)))
            out["next"].append(jax.random.normal(k_next, (BATCH, ACT)))
            out["actor"].append(jax.random.normal(k_actor, (BATCH, ACT)))
    else:
        k_pos, k_env, k_scan = jax.random.split(sub, 3)
        out = {
            "pos": [jax.random.randint(k_pos, (G, BATCH), 0, max(valid, 1))],
            "env": [jax.random.randint(k_env, (G, BATCH), 0, N_ENVS)],
            "next": [],
            "actor": [],
        }
        for k in jax.random.split(jax.random.fold_in(k_scan, 0), G):
            k_next, k_actor = jax.random.split(k)
            out["next"].append(jax.random.normal(k_next, (BATCH, ACT)))
            out["actor"].append(jax.random.normal(k_actor, (BATCH, ACT)))
        out["pos"], out["env"] = out["pos"][0], out["env"][0]
    return {k: torch.from_numpy(np.array(np.stack(v) if isinstance(v, list) else v)).to(
        torch.int64 if k in ("pos", "env") else torch.float32) for k, v in out.items()}


def _compare_params(port_agent, jax_params):
    want = sac_state_from_jax(jax.tree.map(np.asarray, jax_params))
    got = port_agent.state_dict()
    assert set(got) == set(want)
    worst = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)
        worst = max(worst, float((got[k] - v).abs().max()))
    return worst


@pytest.mark.parametrize("prioritized", [True, False], ids=["per", "uniform"])
def test_torch_sac_update_resident_dispatch_matches_jax(prioritized):
    rng = np.random.default_rng(5 if prioritized else 6)
    cfg, fabric, jagent, params, txs, opts = _jax_setup(prioritized)
    jdrb = _filled_jax_ring(fabric, prioritized, rng)
    before = jax.tree.map(np.asarray, params)
    pcfg, agent, optimizers = _port_setup(params)
    pdrb = _port_ring(jdrb, prioritized)

    row = _row(rng)
    beta = 0.55
    flags = [1.0, 1.0]
    key = jnp.asarray(np.asarray(jdrb.state["key"]))  # the dispatch donates the ring state
    jdrb.add(row)
    blob = jdrb.make_job({"__flags__": np.ones(G, np.float32), "__valid__": np.ones(G, np.float32),
                          "__beta__": np.float32(beta)})
    step = jax_resident_step(jagent, *txs, cfg, fabric.mesh, jdrb, G, guard=False, donate=False)
    p_new, aopt, copt, lopt, state, qf, al, ll, _ = step(params, opts[0], opts[1], opts[2], jdrb.state, blob)

    pdrb.add(row)
    job = pdrb.make_job()
    assert (job.pos, job.count, job.valid) == (FILLED, 1, FILLED + 1)
    draws = _jax_resident_draws(key, prioritized, job.valid)
    train = make_resident_train_step(agent, optimizers, pcfg, pdrb)
    losses, _ = train(job, flags, beta, draws=draws)

    np.testing.assert_allclose(losses.numpy(), [float(qf), float(al), float(ll)], **TOL)
    _compare_params(agent, p_new)
    for k in SPECS:
        np.testing.assert_array_equal(pdrb.storage[k].numpy(), np.asarray(state["storage"][k]))
    if prioritized:
        np.testing.assert_allclose(pdrb.tree.numpy(), np.asarray(state["tree"]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(pdrb.max_p), float(state["max_p"]), rtol=1e-5)
        # the dispatch moved the tree: fresh leaves at 3.0, then |TD| priorities
        assert float(state["tree"][jst.leaf_count(CAP * N_ENVS) + FILLED * N_ENVS]) != 0.0
    # the update really moved the weights
    assert np.abs(np.asarray(p_new["actor"]["params"]["fc_mean"]["kernel"])
                  - before["actor"]["params"]["fc_mean"]["kernel"]).max() > 1e-5


def test_torch_sac_update_resident_drain_dispatch_appends_nothing():
    """A backlog-drain dispatch (nothing staged, steps granted) leaves the
    ring and its head as they were, and an append-only dispatch trains
    nothing."""
    rng = np.random.default_rng(7)
    _, fabric, _, params, _, _ = _jax_setup(True)
    pcfg, agent, optimizers = _port_setup(params)
    pdrb = _port_ring(_filled_jax_ring(fabric, True, rng), True)
    train = make_resident_train_step(agent, optimizers, pcfg, pdrb)
    storage = {k: v.clone() for k, v in pdrb.storage.items()}
    job = pdrb.make_job()
    assert (job.blob, job.count, job.pos, job.valid) == (None, 0, FILLED, FILLED)
    losses, _ = train(job, [1.0, 0.0], 0.4)
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    assert all(torch.equal(storage[k], pdrb.storage[k]) for k in SPECS) and pdrb.pos == FILLED
    pdrb.add(_row(rng))
    tree = pdrb.tree.clone()
    assert train(pdrb.make_job(), [], 0.4) is None
    assert pdrb.pos == FILLED + 1 and not torch.equal(tree, pdrb.tree)


def test_torch_sac_update_host_train_step_matches_jax():
    rng = np.random.default_rng(8)
    cfg, fabric, jagent, params, txs, opts = _jax_setup(False)
    pcfg, agent, optimizers = _port_setup(params)
    data = {k: v.reshape(G, BATCH, -1) for k, v in _row(rng, G * BATCH // N_ENVS).items()}
    key = jax.random.PRNGKey(11)
    step = jax_train_step(jagent, *txs, cfg, fabric.mesh, donate=False, guard=False)
    p_new, aopt, copt, lopt, qf, al, ll = step(params, opts[0], opts[1], opts[2], data, key, jnp.float32(1.0))

    noise = {"next": [], "actor": []}
    for k in jax.random.split(jax.random.fold_in(key, 0), G):
        k_next, k_actor = jax.random.split(k)
        noise["next"].append(np.asarray(jax.random.normal(k_next, (BATCH, ACT))))
        noise["actor"].append(np.asarray(jax.random.normal(k_actor, (BATCH, ACT))))
    noise = {k: torch.from_numpy(np.stack(v)) for k, v in noise.items()}
    train = make_train_step(agent, optimizers, pcfg)
    losses, _ = train({k: torch.from_numpy(v) for k, v in data.items()}, True, noise=noise)
    np.testing.assert_allclose(losses.numpy(), [float(qf), float(al), float(ll)], **TOL)
    _compare_params(agent, p_new)


def test_torch_sac_update_without_ema_keeps_the_target_critics():
    rng = np.random.default_rng(9)
    _, _, _, params, _, _ = _jax_setup(False)
    pcfg, agent, optimizers = _port_setup(params)
    target = {k: v.clone() for k, v in agent.target_critic.state_dict().items()}
    data = {k: torch.from_numpy(v.reshape(1, 8, -1)) for k, v in _row(rng, 4).items()}
    make_train_step(agent, optimizers, pcfg)(data, False, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(target[k], v) for k, v in agent.target_critic.state_dict().items())
    assert not all(torch.equal(agent.critic.state_dict()[k], v) for k, v in target.items())
