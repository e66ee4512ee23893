"""SAC's hybrid player against the JAX package's, on the CPU.

- ``make_burst_train_step``: one burst of the port and of JAX
  (``sac.py:make_burst_train_step``, its packed single-upload form) from the
  same flax weights, fresh Adams and the same ring (capacity 16 x 2 envs,
  the write head at 13): 5 staged transitions in a 7-row staging block are
  appended with wrap-around and the 2 padding rows dropped, then the granted
  prefix of a 4-step chunk runs (EMA flags 1, 0, 1, 1). JAX's draws are
  rebuilt from the burst key (``fold_in`` of the device index, ``split`` per
  step, ``split(k, 4)`` into the positions, the envs, the next-action and
  the actor noise) and injected. Tolerances: the ring bit for bit; with 0
  granted steps every parameter exactly as it was; with 2 and 4 every
  parameter within 1e-6; the mean losses (4 granted: JAX's mean over the
  chunk is over the granted steps) within rtol 1e-5, atol 1e-6.
- The slice: ``run preset=sac`` with ``algo.hybrid_player.enabled=true`` on
  the CPU (which turns it on, as in JAX) trains in bursts of
  ``replay_ratio x num_envs x 64`` grants on the trainer thread, runs every
  grant the coupled run runs, checkpoints the host buffer (patched) with the
  host player's generator, and resumes onto the ring; with ``train_every=1``
  the host actor is refreshed every ``refresh_every`` iterations while the
  training stays coupled.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.sac import make_burst_train_step as jax_make_burst
from sheeprl_tpu.config import compose
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_burst_train_step, make_optimizers
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.data.ring import pack_burst_blob
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax
from sheeprl_tpu_torch.utils.utils import Ratio
from tests.test_torch_sac_loop import TINY

HIDDEN, BATCH, CAP, E, OBS, ACT = 32, 16, 16, 2, 3, 1
STAGE_MAX, CHUNK, COUNT, POS, FILLED = 7, 4, 5, 13, 16
DIMS = {"observations": OBS, "next_observations": OBS, "actions": ACT, "rewards": 1, "terminated": 1}
FLAGS = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
OVERRIDES = [f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={BATCH}", f"env.num_envs={E}"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    cfg = compose(["exp=sac"] + OVERRIDES)
    fabric = Fabric(devices=1, accelerator="cpu")
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    agent, params, _ = jax_build_agent(fabric, cfg, obs_space, gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32))
    txs = [jax_build_optimizer(cfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")]
    burst, layout = jax_make_burst(agent, *txs, cfg, fabric.mesh, capacity=CAP, n_envs=E, stage_max=STAGE_MAX,
                                   grad_chunk=CHUNK, dims=DIMS)
    return {"params": params, "txs": txs, "burst": burst, "layout": layout}


def _ring_and_values(granted):
    rng = np.random.default_rng(5)
    ring = {k: rng.normal(size=(CAP, E, d)).astype(np.float32) for k, d in DIMS.items()}
    ring["actions"] = rng.uniform(-2, 2, size=(CAP, E, ACT)).astype(np.float32)
    ring["terminated"] = (rng.random((CAP, E, 1)) < 0.2).astype(np.float32)
    staged = {k: np.zeros((STAGE_MAX, E, d), np.float32) for k, d in DIMS.items()}
    for k in DIMS:
        staged[k][:COUNT] = rng.normal(size=(COUNT, E, DIMS[k])).astype(np.float32)
    valid = np.zeros(CHUNK, np.float32)
    valid[:granted] = 1.0
    values = {**staged, "__pos__": np.asarray(POS, np.int32), "__count__": np.asarray(COUNT, np.int32),
              "__valid_n__": np.asarray(FILLED, np.int32), "__flags__": FLAGS * valid, "__valid__": valid}
    return ring, values


def _jax_draws(key, granted):
    out = {"pos": [], "env": [], "next": [], "actor": []}
    for k in jax.random.split(jax.random.fold_in(key, 0), CHUNK)[:granted]:
        k_idx, k_env, k_next, k_actor = jax.random.split(k, 4)
        out["pos"].append(jax.random.randint(k_idx, (BATCH,), 0, FILLED))
        out["env"].append(jax.random.randint(k_env, (BATCH,), 0, E))
        out["next"].append(jax.random.normal(k_next, (BATCH, ACT)))
        out["actor"].append(jax.random.normal(k_actor, (BATCH, ACT)))
    return {k: torch.from_numpy(np.array(np.stack(v))).to(torch.int64 if k in ("pos", "env") else torch.float32)
            for k, v in out.items()}


def _burst(jax_side, granted):
    params, txs = jax_side["params"], jax_side["txs"]
    opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
    ring, values = _ring_and_values(granted)
    key = jax.random.PRNGKey(17)
    blob = jax_pack(jax_side["layout"], {**values, "__key__": np.asarray(key, np.uint32)})
    jparams, _, _, _, jrb, qf, al, ll = jax_side["burst"](params, *opts, {k: jnp.asarray(v) for k, v in ring.items()},
                                                          jnp.asarray(blob))
    cfg = apply_overrides(preset("sac"), OVERRIDES + [f"algo.actor.hidden_size={HIDDEN}",
                                                      f"algo.critic.hidden_size={HIDDEN}"])
    before = sac_state_from_jax(jax.tree.map(np.asarray, params))
    agent, _ = build_agent(cfg, OBS, {"shape": [ACT], "low": [-2.0], "high": [2.0]}, "cpu", before)
    port_burst, layout = make_burst_train_step(agent, make_optimizers(cfg, agent), cfg, CAP, E, STAGE_MAX, CHUNK,
                                               DIMS)
    rb = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    losses = port_burst(rb, pack_burst_blob(layout, values), None, _jax_draws(key, granted) if granted else None)
    return {"ring": ring, "jax_rb": {k: np.asarray(v) for k, v in jrb.items()}, "port_rb": rb, "before": before,
            "jax_params": sac_state_from_jax(jax.tree.map(np.asarray, jparams)), "port_params": agent.state_dict(),
            "jax_losses": [float(qf), float(al), float(ll)], "port_losses": losses}


@pytest.mark.parametrize("granted", [0, 2, CHUNK])
def test_torch_hybrid_sac_burst_matches_jax(jax_side, granted):
    out = _burst(jax_side, granted)
    for k in DIMS:  # rows 13, 14, 15, 0, 1 written; the padding rows dropped
        np.testing.assert_array_equal(out["port_rb"][k].numpy(), out["jax_rb"][k], err_msg=k)
        changed = np.flatnonzero((out["jax_rb"][k] != out["ring"][k]).any(axis=(1, 2))).tolist()
        assert changed == [0, 1, 13, 14, 15], k
    want, got = out["jax_params"], out["port_params"]
    assert set(got) == set(want)
    for name, value in want.items():
        if granted == 0:
            assert torch.equal(got[name], out["before"][name]) and torch.equal(value, out["before"][name]), name
        else:
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=name)
    assert granted == 0 or any(not torch.equal(got[n], out["before"][n]) for n in got)
    if granted == 0:
        assert out["port_losses"] is None
    elif granted == CHUNK:
        np.testing.assert_allclose(out["port_losses"].numpy(), out["jax_losses"], rtol=1e-5, atol=1e-6)


# -- the slice: a hybrid SAC run on the CPU -----------------------------------


def _expected_bursts(cfg, iters, learning_starts):
    """JAX's burst accounting for a run of ``iters`` iterations: the grants
    of each iteration from ``Ratio``, a flush whenever a full chunk is
    queued or the staging rows are about to overflow, and the tail."""
    n_envs, train_every = int(cfg.env.num_envs), 64
    chunk = round(float(cfg.algo.replay_ratio) * n_envs * train_every)
    stage_max = min(learning_starts + 2 * train_every + 1, int(cfg.buffer.size) // n_envs)
    ratio, prefill = Ratio(float(cfg.algo.replay_ratio)), learning_starts - int(learning_starts > 0)
    staged = backlog = grants = trained = 0

    def flush():
        nonlocal staged, backlog, grants, trained
        take = min(chunk, backlog)
        staged, backlog, grants, trained = 0, backlog - take, grants + take, trained + int(take > 0)

    for it in range(1, iters + 1):
        staged += 1
        if it >= learning_starts:
            backlog += ratio(it * n_envs - prefill + n_envs)
        while backlog >= chunk or staged >= stage_max - 1:
            flush()
            if backlog < chunk:
                break
    while staged or backlog:
        flush()
    return chunk, grants, trained


def test_torch_hybrid_sac_run_trains_in_bursts_checkpoints_and_resumes(tmp_path):
    args = ["preset=sac"] + TINY + ["algo.hybrid_player.enabled=true", "algo.total_steps=400", f"log_root={tmp_path}"]
    s = cli.run(args)
    cfg = cli.compose_run_config(args)
    chunk, grants, trained = _expected_bursts(cfg, 200, 16)
    assert s["hybrid"] and s["burst"] and not s["resident"] and s["grad_chunk"] == chunk == 128
    assert s["gradient_steps"] == grants and s["train_calls"] == s["bursts"] == trained >= 3
    assert len(s["losses"]) == trained and np.isfinite(np.asarray(s["losses"])).all()
    coupled = cli.run(args[:-1] + ["algo.hybrid_player.enabled=false", f"log_root={tmp_path / 'coupled'}"])
    assert coupled["gradient_steps"] == grants  # every grant the coupled run takes, in bursts
    state = load_checkpoint(s["checkpoint"])
    assert state["host_rng"] is not None and state["rb"]["pos"] == 200 and state["rb"]["full"] is False
    assert state["rb"]["buffer"]["truncated"][-1].tolist() == [[1], [1]]  # the checkpoint's truncation patch
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=600", f"log_root={tmp_path}",
                       "algo.learning_starts=32", "fabric.accelerator=cpu", "algo.hybrid_player.enabled=true"])
    assert resumed["burst"] and resumed["gradient_steps"] > 0 and resumed["policy_steps"] == 600


def test_torch_hybrid_sac_run_without_bursts_refreshes_the_host_actor(tmp_path):
    s = cli.run(["preset=sac"] + TINY + ["algo.hybrid_player.enabled=true", "algo.hybrid_player.train_every=1",
                                         "algo.hybrid_player.refresh_every=8", "algo.total_steps=200",
                                         f"log_root={tmp_path}"])
    assert s["hybrid"] and not s["burst"] and s["gradient_steps"] > 0
    # iterations 17..100 past learning_starts, a refresh every 8: the host actor moved with the card's
    assert s["snapshot"]["polls"] >= 8 and s["snapshot"]["host_version"] > 16


def test_torch_hybrid_sac_next_obs_disables_the_burst(tmp_path):
    with pytest.warns(UserWarning, match="not supported by burst training"):
        s = cli.run(["preset=sac"] + TINY + ["algo.hybrid_player.enabled=true", "buffer.sample_next_obs=true",
                                             "algo.total_steps=80", f"log_root={tmp_path}"])
    assert s["hybrid"] and not s["burst"] and s["gradient_steps"] > 0
