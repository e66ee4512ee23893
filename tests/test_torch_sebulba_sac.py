"""The port's off-policy async topologies on the CPU: the decoupled replay
helpers and the append-free dispatch against the JAX package's, and the
``sac_sebulba`` and ``sac_decoupled`` loops through ``cli.run``.

Parity:

- ``pack_rows`` then appends of 3, 2, 3 and 1 rows (``stage_rows`` 3, a ring
  of 7 x 2 envs, so it wraps) with PER, against JAX's ``DeviceReplayBuffer``
  (``pack_rows``, ``make_append_step``, ``note_append``): the storage, the
  head, the valid count, the sum-tree and ``max_p`` exactly; the JAX blob's
  segments unpack from the port's blob byte for byte;
- one append-free dispatch (``make_resident_train_step(append=False)``, 2
  gradient steps at ``exp=sac``'s recipe cut to hidden 32, batch 16) against
  JAX's, uniform and PER, fed JAX's draws (``tests/test_torch_sac_update.py``
  rebuilds them from the ring key): the three mean losses within rtol 1e-5
  (atol 1e-6), every parameter, the sum-tree and ``max_p`` within 1e-6, and
  the storage untouched.

The loops run at the JAX tests' small sizes (the continuous counter env,
hidden 16, batch 8, ``learning_starts`` 4): a run, the replay-ratio
governor's bound ``|grad steps - ratio (consumed - prefill)| <= ratio + 1``
(JAX's ``test_sac_sebulba_replay_ratio_governor``, where ``prefill`` is the
offset the governor counts from, ``prefill_steps - policy_steps_per_iter``),
back-pressure under 3 actors on a queue of one, PER, a checkpoint and a
resume that restores the ring exactly, evaluation and serving of the
checkpoint, a killed actor restarted with the clean twin's counters, zero
survivors aborting typed, and ``sac_decoupled``'s run, resume and
evaluation. Every wait carries its own limit.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.sac import make_resident_train_step as jax_resident_step
from sheeprl_tpu.data.ring import unpack_burst_blob as jax_unpack
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.replay import DeviceReplayBuffer as JaxDeviceReplayBuffer
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step
from sheeprl_tpu_torch.data.ring import unpack_burst_blob
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.supervisor import AllWorkersDeadError, WorkerAbortError
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax
from tests.test_torch_sac_update import (
    FILLED,
    G,
    SPECS,
    TOL,
    _filled_jax_ring,
    _jax_resident_draws,
    _jax_setup,
    _port_ring,
    _port_setup,
)

SEBULBA_FAST = [
    "preset=sac_sebulba", "fabric.accelerator=cpu", "env.id=continuous_dummy", "env.screen_size=64", "env.num_envs=2",
    "buffer.size=64",
    "metric.log_level=0", "algo.run_test=false", "algo.per_rank_batch_size=8", "algo.hidden_size=16",
    "algo.actor.hidden_size=16", "algo.critic.hidden_size=16", "algo.mlp_keys.encoder=[state]",
    "algo.learning_starts=4", "algo.total_steps=32", "checkpoint.save_last=false", "checkpoint.every=0",
    "fault.supervisor.join_s=5",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inject.reset()
    yield
    inject.reset()
    torch.set_num_threads(n)


def _rows(rng, count, n_envs=2, obs=3, act=1):
    return [{
        "observations": rng.normal(size=(n_envs, obs)).astype(np.float32),
        "next_observations": rng.normal(size=(n_envs, obs)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(n_envs, act)).astype(np.float32),
        "rewards": rng.normal(size=(n_envs, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(n_envs, 1)) < 0.3).astype(np.float32),
    } for _ in range(count)]


def test_torch_sebulba_sac_pack_rows_and_appends_match_jax():
    cap, n_envs, stage = 7, 2, 3
    rng = np.random.default_rng(0)
    specs = {k: ((3,) if "obs" in k else (1,), np.float32) for k in SPECS}
    fabric = Fabric(devices=1, accelerator="cpu")
    jdrb = JaxDeviceReplayBuffer(fabric, {k: (s, jnp.float32) for k, (s, _) in specs.items()}, cap, n_envs,
                                 prioritized=True, stage_rows=stage, seed=3)
    jappend = jdrb.make_append_step(donate=False)
    pdrb = DeviceReplayBuffer(specs, cap, n_envs, prioritized=True, seed=3, stage_rows=stage)
    pappend = pdrb.make_append_step()
    for i, count in enumerate((3, 2, 3, 1)):
        rows = _rows(rng, count)
        jblob = jdrb.pack_rows(rows)
        pblob = pdrb.pack_rows(rows)
        assert pblob.dtype == torch.uint8 and pblob.numel() == pdrb.append_layout.nbytes
        got, want = unpack_burst_blob(pblob, pdrb.append_layout), jax_unpack(jnp.asarray(jblob), jdrb.append_layout)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        jdrb.state = jappend(jdrb.state, jnp.asarray(jblob))
        jdrb.note_append(count)
        pappend(pblob, count)
        pdrb.note_append(count)
        if i == 1:  # fresh leaves enter at max_p: raise it as a train dispatch would
            jdrb.state["max_p"] = jnp.float32(2.5)
            pdrb.max_p.fill_(2.5)
    for k in specs:
        np.testing.assert_array_equal(pdrb.storage[k].numpy(), np.asarray(jdrb.state["storage"][k]), err_msg=k)
    assert (pdrb.pos, pdrb.valid_rows, pdrb.full) == (int(jdrb.state["pos"]), int(jdrb.state["valid"]), True)
    assert (pdrb.pos, pdrb.valid_rows) == (jdrb.pos, jdrb.valid_rows) == (2, 7)
    np.testing.assert_array_equal(pdrb.tree.numpy(), np.asarray(jdrb.state["tree"]))
    assert float(pdrb.max_p) == float(jdrb.state["max_p"])
    assert float(pdrb.tree[pdrb.tree_leaves + 5 * n_envs]) == 2.5  # the 3rd blob's rows: after the raise
    assert pdrb.metrics()["Replay/inserts"] == 9 * n_envs and pdrb.metrics()["Replay/flushes"] == 4
    with pytest.raises(ValueError, match="stage_rows"):
        pdrb.pack_rows(_rows(rng, 4))
    ctl = pdrb.make_ctl_job([1.0, 0.0], 0.7)
    assert ctl.flags == (1.0, 0.0) and ctl.beta == pytest.approx(0.7) and ctl.valid == 7


def _max_gap(port_agent, jax_params):
    want = sac_state_from_jax(jax.tree.map(np.asarray, jax_params))
    got = port_agent.state_dict()
    return max(float((got[k] - v).abs().max()) for k, v in want.items())


@pytest.mark.parametrize("prioritized", [True, False], ids=["per", "uniform"])
def test_torch_sebulba_sac_append_free_dispatch_matches_jax(prioritized):
    rng = np.random.default_rng(15 if prioritized else 16)
    cfg, fabric, jagent, params, txs, opts = _jax_setup(prioritized)
    jdrb = _filled_jax_ring(fabric, prioritized, rng)
    pcfg, agent, optimizers = _port_setup(params)
    pdrb = _port_ring(jdrb, prioritized)
    storage = {k: v.clone() for k, v in pdrb.storage.items()}
    beta = 0.55
    key = jnp.asarray(np.asarray(jdrb.state["key"]))  # the dispatch donates the ring state
    tree_before = np.array(jdrb.state["tree"]) if prioritized else None
    ctl = jdrb.make_ctl_job({"__flags__": np.ones(G, np.float32), "__valid__": np.ones(G, np.float32),
                             "__beta__": np.float32(beta)})
    step = jax_resident_step(jagent, *txs, cfg, fabric.mesh, jdrb, G, guard=False, donate=False, append=False)
    p_new, _, _, _, state, qf, al, ll, _ = step(params, opts[0], opts[1], opts[2], jdrb.state, ctl)

    K.reset_launches()
    train = make_resident_train_step(agent, optimizers, pcfg, pdrb, append=False)
    assert train(pdrb.make_ctl_job([], beta)) is None  # no grant, no step
    pctl = pdrb.make_ctl_job([1.0] * G, beta)
    assert pctl.valid == FILLED
    losses, skipped = train(pctl, draws=_jax_resident_draws(key, prioritized, FILLED))
    assert K.LAUNCHES["sumtree_sample"] == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(losses.numpy(), [float(qf), float(al), float(ll)], **TOL)
    assert float(skipped) == 0.0
    assert _max_gap(agent, p_new) <= 1e-6
    for k in SPECS:  # the train-only dispatch appends nothing
        assert torch.equal(pdrb.storage[k], storage[k])
        np.testing.assert_array_equal(pdrb.storage[k].numpy(), np.asarray(state["storage"][k]))
    assert int(state["pos"]) == pdrb.pos == FILLED
    if prioritized:
        np.testing.assert_allclose(pdrb.tree.numpy(), np.asarray(state["tree"]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(float(pdrb.max_p), float(state["max_p"]), atol=1e-6, rtol=1e-6)
        # the dispatch wrote |TD| priorities: the tree moved from the filled one
        assert not np.array_equal(np.asarray(state["tree"]), tree_before)


# -- the loops through cli.run -----------------------------------------------------------


def _ckpts(root):
    return sorted(glob.glob(f"{root}/**/ckpt_*.ckpt", recursive=True), key=os.path.getmtime)


def test_torch_sebulba_sac_governor_holds_the_replay_ratio(tmp_path):
    ratio = 2.0
    out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "env.num_envs=1", f"algo.replay_ratio={ratio}",
                                  "algo.learning_starts=8", "algo.total_steps=128", "algo.sebulba.rollout_block=4"])
    pipe = out["pipeline"]
    consumed, grads = pipe["Pipeline/env_steps_consumed"], pipe["Pipeline/grad_steps"]
    assert consumed >= 128 and grads == out["gradient_steps"]
    offset = out["prefill_policy_steps"] - 1  # prefill_steps - policy_steps_per_iter, 1 env
    assert abs(grads - ratio * (consumed - offset)) <= ratio + 1, (grads, consumed, offset)
    assert pipe["Pipeline/replay_ratio_actual"] == pytest.approx(grads / consumed, abs=1e-3)
    assert len(out["losses"]) == out["train_calls"] and np.isfinite(np.asarray(out["losses"])).all()


def test_torch_sebulba_sac_backpressure_and_per(tmp_path):
    out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/a", "algo.total_steps=96", "algo.sebulba.num_actor_threads=3",
                                  "algo.sebulba.queue_depth=1", "algo.sebulba.publish_every=2"])
    pipe = out["pipeline"]
    assert pipe["Pipeline/env_steps_consumed"] >= 96 and pipe["Pipeline/max_queue_depth"] <= 1
    assert pipe["Pipeline/rollouts_produced"] >= pipe["Pipeline/rollouts_consumed"] > 0
    assert pipe["Pipeline/actor_stall_s"] > 0 and "Pipeline/learner_starved_s" in pipe
    K.reset_launches()
    per = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/b", "buffer.priority.enabled=true"])
    assert per["prioritized"] and per["gradient_steps"] > 0 and np.isfinite(np.asarray(per["losses"])).all()
    assert K.LAUNCHES["sumtree_sample"] == 0


def test_torch_sebulba_sac_checkpoint_resume_restores_the_ring_and_serves(tmp_path):
    first = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/a", "env.num_envs=1", "algo.total_steps=48",
                                    "algo.sebulba.rollout_block=4", "checkpoint.every=16", "checkpoint.save_last=true",
                                    "buffer.priority.enabled=true", "seed=11"])
    ckpts = _ckpts(f"{tmp_path}/a")
    assert [os.path.basename(c) for c in ckpts] == ["ckpt_16_0.ckpt", "ckpt_32_0.ckpt", "ckpt_48_0.ckpt"]
    mid = load_checkpoint(ckpts[1])
    assert {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "ratio", "iter_num", "rng", "actor_rng",
            "rb"} <= set(mid)
    saved = DeviceReplayState.from_dict(mid["rb"])
    assert int(saved.arrays["valid"]) == 32 and "tree" in saved.arrays and "max_p" in saved.arrays
    restored = {}
    import importlib

    seb = importlib.import_module("sheeprl_tpu_torch.algos.sac.sac_sebulba")

    class _Recording(DeviceReplayBuffer):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    original = seb.DeviceReplayBuffer
    seb.DeviceReplayBuffer = _Recording
    try:
        resumed = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/b", f"checkpoint.resume_from={ckpts[1]}",
                                          "env.num_envs=1", "algo.total_steps=48", "algo.sebulba.rollout_block=4",
                                          "algo.learning_starts=0", "checkpoint.save_last=true",
                                          "buffer.priority.enabled=true", "seed=11"])
    finally:
        seb.DeviceReplayBuffer = original
    assert all(torch.equal(restored[k], v) for k, v in saved.arrays.items()), sorted(restored)
    assert resumed["start_iter"] == 33 and resumed["policy_steps"] == 48
    last = load_checkpoint(_ckpts(f"{tmp_path}/b")[-1])
    assert int(DeviceReplayState.from_dict(last["rb"]).arrays["valid"]) == 48  # the pre-resume rows stayed
    assert torch.equal(last["actor_rng"], mid["actor_rng"])
    result = cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])
    assert result["device"] == "cpu" and result["steps"] > 0
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    serve_cfg = cli.compose_serve_config([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])
    policy = resolve_policy_builder(serve_cfg.algo.name)(serve_cfg, load_checkpoint(ckpts[-1]), torch.device("cpu"))
    rows = {k: torch.from_numpy(v) for k, v in policy.prepare({"state": np.zeros((3, 10), np.float32)}, 3).items()}
    with torch.no_grad():
        acts = policy.greedy_fn(policy.params, rows)
    assert serve_cfg.algo.name == "sac_sebulba" and acts.shape == (3, 2)


CHAOS = SEBULBA_FAST + ["buffer.size=128", "algo.total_steps=64", "algo.sebulba.num_actor_threads=3",
                        "algo.sebulba.rollout_block=4", "fault.supervisor.backoff=0.0"]


def test_torch_sebulba_sac_killed_actor_restarts_with_the_clean_counters(tmp_path):
    clean = cli.run(CHAOS + [f"log_root={tmp_path}/clean"])
    assert clean["pipeline"]["Pipeline/actor_deaths"] == 0 and clean["pipeline"]["Pipeline/actors_live"] == 3
    inject.arm("sac_sebulba.actor1.step", action="kill-thread", at=10)
    with pytest.warns(UserWarning, match="sac-sebulba-actor-1.*restarting"):
        chaos = cli.run(CHAOS + [f"log_root={tmp_path}/chaos"])
    pipe = chaos["pipeline"]
    assert pipe["Pipeline/actor_deaths"] == 1 and pipe["Pipeline/actor_restarts"] == 1
    assert pipe["Pipeline/actors_live"] == 3
    assert chaos["policy_steps"] == clean["policy_steps"]
    assert pipe["Pipeline/env_steps_consumed"] == clean["pipeline"]["Pipeline/env_steps_consumed"]


def test_torch_sebulba_sac_zero_survivors_and_no_supervision_fail_typed(tmp_path):
    inject.arm("sac_sebulba.actor0.step", action="raise", at=6)
    with pytest.warns(UserWarning):
        with pytest.raises(AllWorkersDeadError, match="sac-sebulba-actor-0"):
            cli.run(CHAOS + [f"log_root={tmp_path}/a", "algo.sebulba.num_actor_threads=1",
                             "fault.supervisor.max_restarts=0"])
    inject.arm("sac_sebulba.actor0.step", action="raise", at=6)
    with pytest.raises(WorkerAbortError, match="sac-sebulba-actor-0"):
        cli.run(CHAOS + [f"log_root={tmp_path}/b", "fault.supervisor.enabled=false"])


def test_torch_sebulba_sac_chaos_schedule_from_the_config(tmp_path):
    with pytest.warns(UserWarning, match="restarting"):
        out = cli.run(CHAOS + [f"log_root={tmp_path}", "fault.chaos.enabled=true", "fault.chaos.seed=3",
                               "fault.chaos.events=['sac_sebulba.actor1.step:raise:8-16']"])
    assert out["pipeline"]["Pipeline/actor_deaths"] == 1 and out["pipeline"]["Pipeline/actors_live"] == 3


def test_torch_sebulba_sac_decoupled_trains_resumes_and_evaluates(tmp_path):
    fast = ["preset=sac_decoupled", "fabric.accelerator=cpu", "env.id=continuous_dummy", "env.screen_size=64", "env.num_envs=2",
            "buffer.size=128", "metric.log_level=0", "algo.run_test=false", "algo.per_rank_batch_size=8",
            "algo.hidden_size=16", "algo.actor.hidden_size=16", "algo.critic.hidden_size=16",
            "algo.mlp_keys.encoder=[state]", "algo.learning_starts=8"]
    first = cli.run(fast + [f"log_root={tmp_path}/a", "algo.total_steps=64", "checkpoint.every=32"])
    assert first["policy_steps"] == 64 and first["gradient_steps"] > 0 and np.isfinite(np.asarray(first["losses"])).all()
    ckpts = _ckpts(f"{tmp_path}/a")
    assert [os.path.basename(c) for c in ckpts] == ["ckpt_32_0.ckpt", "ckpt_64_0.ckpt"]
    mid = load_checkpoint(ckpts[0])
    assert {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "ratio", "rb", "rng"} <= set(mid)
    resumed = cli.run(fast + [f"log_root={tmp_path}/b", f"checkpoint.resume_from={ckpts[0]}",
                              "algo.learning_starts=0"])
    assert resumed["start_iter"] == 17 and resumed["policy_steps"] == 64 and resumed["gradient_steps"] > 0
    assert cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])["steps"] > 0
