"""The port's on-policy async topologies on the CPU: ``ppo_sebulba``'s actor
programs against the JAX package's, and the ``ppo_sebulba`` and
``ppo_decoupled`` loops through ``cli.run``.

Parity (weights carried across by ``ppo_state_from_jax``, every leaf
perturbed so zero biases are carried too; JAX's draws fed to the port):

- ``make_act_step``: the env actions of discrete (2 actions), multi-discrete
  (3 x 4) and continuous (2 dims) heads, at a batch of 4 envs and of 2
  groups x 4 (``env_groups`` 2): indices equal, continuous within atol 1e-5
  (``mean + exp(log_std) * eps`` over float32 sums in another order; the
  largest gap measured, 1.4e-6, on observations scaled up to 6).
  JAX's draws: the step key's uniforms in [tiny, 1) for one head,
  ``split(key, n_heads)``'s for several, its normals for the continuous one;
- ``make_traj_step``: log-probs and values of a 128 x 4 trajectory within
  atol 1e-5, rtol 1e-5 (float32 on both sides, sums in another order), one
  and several heads (``head_split``), and continuous;
- the actor's slab -> ``finish_item`` (trajectory forward, then ``gae``) ->
  the flattened item at (128, 4, 1) against JAX's ``traj_fn`` then ``gae``
  on the same slab, with the truncation bootstrap ``r += gamma * V(final
  obs)`` in the rewards: returns and advantages within atol 1e-4, rtol 1e-5
  (128-step recurrences over float32 values that already differ by ~1e-6).

The loops run at the JAX tests' small sizes (``SEBULBA_FAST``: the counter
env, 2 envs x 8 steps, batch 4, one epoch): train, checkpoint, resume (the
learner's stream continues exactly, the actors' base state rides along),
evaluation and serving of the checkpoint, many actors on a queue of one,
``env_groups``, a killed actor restarted, a hung one degrading the pool,
zero survivors aborting with the typed error, and a rollback re-publishing.
Every run ends within the supervisor's join budget; nothing waits without
a limit.
"""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.ppo_sebulba import make_act_step as jax_make_act_step
from sheeprl_tpu.algos.ppo.ppo_sebulba import make_traj_step as jax_make_traj_step
from sheeprl_tpu.ops import gae as jax_gae
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo_sebulba import finish_item, make_act_step, make_traj_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault.supervisor import AllWorkersDeadError
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax

TINY = float(np.finfo(np.float32).tiny)
CASES = {
    "discrete": ((2,), False),
    "multi-discrete": ((3, 4), False),
    "continuous": ((2,), True),
}
OBS_DIM = 4

SEBULBA_FAST = [
    "preset=ppo_sebulba", "fabric.accelerator=cpu", "env.id=discrete_dummy", "env.num_envs=2",
    "metric.log_level=0", "algo.run_test=false", "algo.rollout_steps=8", "buffer.size=8",
    "algo.per_rank_batch_size=4", "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]",
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


def _pair(case, seed=0):
    actions_dim, continuous = CASES[case]
    cfg = apply_overrides(preset("ppo"), ["algo.mlp_keys.encoder=[state]"])
    jax_agent = JaxPPOAgent(actions_dim=actions_dim, is_continuous=continuous, cnn_keys=(), mlp_keys=("state",),
                            encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                            critic_cfg=dict(cfg.algo.critic))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jax_agent.init(jax.random.PRNGKey(seed), {"state": jnp.zeros((1, OBS_DIM))}))
    params = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    agent, _ = build_agent(cfg, actions_dim, continuous, {"state": {"shape": [OBS_DIM]}}, "cpu",
                           ppo_state_from_jax(params))
    return jax_agent, params, agent.requires_grad_(False), actions_dim, continuous


def _jax_draws(key, actions_dim, continuous, batch):
    """The draws JAX's act step takes from its step key, as the port's."""
    if continuous:
        return [torch.from_numpy(np.array(jax.random.normal(key, (batch, sum(actions_dim)))))]
    keys = [key] if len(actions_dim) == 1 else list(jax.random.split(key, len(actions_dim)))
    return [torch.from_numpy(np.array(jax.random.uniform(k, (batch, d), minval=TINY, maxval=1.0)))
            for k, d in zip(keys, actions_dim)]


@pytest.mark.parametrize("batch", [4, 8], ids=["groups1", "groups2"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_sebulba_ppo_act_step_matches_jax(case, batch):
    jax_agent, params, agent, actions_dim, continuous = _pair(case)
    n_heads = 1 if continuous else len(actions_dim)
    jax_act = jax.jit(jax_make_act_step(jax_agent, continuous, n_heads))
    act = make_act_step(continuous)
    rng = np.random.default_rng(1)
    for step, key in enumerate(jax.random.split(jax.random.PRNGKey(7), 6)):
        obs = rng.normal(size=(batch, OBS_DIM)).astype(np.float32) * (1 + step)
        want = np.asarray(jax_act(params, key, {"state": jnp.asarray(obs)}))
        with torch.no_grad():
            got = act(agent, {"state": torch.from_numpy(obs)}, _jax_draws(key, actions_dim, continuous, batch))
        assert got.shape == want.shape
        if continuous:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def _trajectory(rng, actions_dim, continuous, rows):
    obs = rng.normal(size=(rows, OBS_DIM)).astype(np.float32)
    if continuous:
        actions = rng.normal(size=(rows, sum(actions_dim))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, rows)] for d in actions_dim], -1)
    return obs, actions


@pytest.mark.parametrize("case", list(CASES))
def test_torch_sebulba_ppo_traj_step_matches_jax(case):
    jax_agent, params, agent, actions_dim, continuous = _pair(case, seed=2)
    n_heads = 1 if continuous else len(actions_dim)
    head_split = np.cumsum(np.asarray(actions_dim[:-1], dtype=np.int64)).tolist()
    obs, actions = _trajectory(np.random.default_rng(3), actions_dim, continuous, 128 * 4)
    want_lp, want_v = jax.jit(jax_make_traj_step(jax_agent, (), ("state",), continuous, n_heads, head_split))(
        params, {"state": jnp.asarray(obs)}, jnp.asarray(actions))
    with torch.no_grad():
        got_lp, got_v = make_traj_step((), ("state",), continuous, n_heads, head_split)(
            agent, {"state": torch.from_numpy(obs)}, torch.from_numpy(actions))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5, rtol=1e-5)


def test_torch_sebulba_ppo_slab_to_item_matches_jax():
    """One actor rollout slab (T 128, N 4, CartPole-shaped observations,
    episodes ending and cut by the time limit) -> the flattened item."""
    T, N, gamma, lam = 128, 4, 0.99, 0.95
    jax_agent, params, agent, actions_dim, continuous = _pair("discrete", seed=4)
    rng = np.random.default_rng(5)
    obs, actions = _trajectory(rng, actions_dim, continuous, T * N)
    final_obs = rng.normal(size=(T, N, OBS_DIM)).astype(np.float32)
    terminated = rng.uniform(size=(T, N)) < 0.03
    truncated = (rng.uniform(size=(T, N)) < 0.03) & ~terminated
    raw_rewards = np.ones((T, N), np.float32)
    # the truncation bootstrap, each side with its own values of the final observations
    want_final_v = np.asarray(jax_agent.apply(params, {"state": jnp.asarray(final_obs.reshape(-1, OBS_DIM))})[1])
    with torch.no_grad():
        got_final_v = agent({"state": torch.from_numpy(final_obs.reshape(-1, OBS_DIM))})[1].numpy()
    np.testing.assert_allclose(got_final_v, want_final_v, atol=1e-5, rtol=1e-5)
    j_rewards = raw_rewards + np.where(truncated, gamma * want_final_v.reshape(T, N), 0).astype(np.float32)
    p_rewards = raw_rewards + np.where(truncated, gamma * got_final_v.reshape(T, N), 0).astype(np.float32)
    dones = (terminated | truncated).astype(np.uint8).reshape(T, N, 1)
    next_obs = rng.normal(size=(N, OBS_DIM)).astype(np.float32)

    traj = jax.jit(jax_make_traj_step(jax_agent, (), ("state",), False, 1, []))
    j_lp, j_v = traj(params, {"state": jnp.asarray(obs)}, jnp.asarray(actions))
    j_next = jax_agent.apply(params, {"state": jnp.asarray(next_obs)})[1]
    j_ret, j_adv = jax_gae(jnp.asarray(j_rewards.reshape(T, N, 1)), j_v.reshape(T, N, 1), jnp.asarray(dones), j_next,
                           gamma, lam)

    slab = {"state": torch.from_numpy(obs.reshape(T, N, OBS_DIM)), "actions": torch.from_numpy(actions.reshape(T, N, -1)),
            "rewards": torch.from_numpy(p_rewards.reshape(T, N, 1)), "dones": torch.from_numpy(dones)}
    K.reset_launches()
    with torch.no_grad():
        next_values = agent({"state": torch.from_numpy(next_obs)})[1]
        item = finish_item(agent, make_traj_step((), ("state",), False, 1, []), slab, next_values, ["state"], gamma, lam)
    assert K.LAUNCHES["gae"] == 0  # CPU tensors take gae's plain version
    assert set(item) == {"state", "actions", "rewards", "dones", "logprobs", "values", "returns", "advantages"}
    assert all(v.shape[0] == T * N for v in item.values())
    np.testing.assert_allclose(item["logprobs"].numpy(), np.asarray(j_lp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(item["values"].numpy(), np.asarray(j_v), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(item["returns"].numpy(), np.asarray(j_ret).reshape(T * N, 1), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(item["advantages"].numpy(), np.asarray(j_adv).reshape(T * N, 1), atol=1e-4, rtol=1e-5)
    assert truncated.any() and terminated.any()


# -- the loops through cli.run -----------------------------------------------------------


def _ckpts(root):
    return sorted(glob.glob(f"{root}/**/ckpt_*.ckpt", recursive=True), key=os.path.getmtime)


def test_torch_sebulba_ppo_trains_checkpoints_resumes_and_serves(tmp_path):
    """4 iterations, a save every one; a resume from the second continues
    the learner's generator exactly (its last save's state equals the first
    run's), the base actor state rides along; the checkpoint evaluates and
    serves under the ``ppo_sebulba`` name."""
    K.reset_launches()
    first = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/a", "algo.total_steps=64", "checkpoint.every=16"])
    assert first["device"] == "cpu" and first["iterations"] == 4 and first["policy_steps"] == 64
    assert len(first["losses"]) == 4 and np.isfinite(np.asarray(first["losses"])).all()
    assert K.LAUNCHES["gae"] == 0
    pipe = first["pipeline"]
    assert pipe["Pipeline/rollouts_consumed"] == 4 and pipe["staleness_max"] <= pipe["staleness_bound"] == 5
    assert pipe["Pipeline/publishes"] == 5  # the initial one, then one per update
    # every finished item was trained on or counted in flight at the stop
    assert pipe["Pipeline/rollouts_produced"] + pipe["Pipeline/rollouts_dropped"] == 4 + first["items_in_flight_at_shutdown"]
    ckpts = _ckpts(f"{tmp_path}/a")
    assert [os.path.basename(c) for c in ckpts] == [f"ckpt_{16 * i}_0.ckpt" for i in (1, 2, 3, 4)]
    saved = [load_checkpoint(c) for c in ckpts]
    assert {"agent", "optimizer", "scheduler", "iter_num", "batch_size", "last_log", "last_checkpoint", "rng",
            "actor_rng"} <= set(saved[0])
    assert all(torch.equal(s["actor_rng"], saved[0]["actor_rng"]) for s in saved)
    assert not torch.equal(saved[1]["rng"], saved[3]["rng"])

    resumed = cli.run(SEBULBA_FAST + [f"checkpoint.resume_from={ckpts[1]}", f"log_root={tmp_path}/b"])
    assert resumed["start_iter"] == 3 and resumed["iterations"] == 2 and resumed["policy_steps"] == 64
    last = load_checkpoint(_ckpts(f"{tmp_path}/b")[-1])
    assert last["iter_num"] == 4 and torch.equal(last["rng"], saved[3]["rng"])  # the learner's stream continued
    assert torch.equal(last["actor_rng"], saved[0]["actor_rng"])

    result = cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])
    assert result["device"] == "cpu" and result["steps"] > 0
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    serve_cfg = cli.compose_serve_config([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])
    policy = resolve_policy_builder(serve_cfg.algo.name)(serve_cfg, saved[3], torch.device("cpu"))
    rows = {k: torch.from_numpy(v) for k, v in policy.prepare({"state": np.zeros((3, 10), np.float32)}, 3).items()}
    with torch.no_grad():
        acts = policy.greedy_fn(policy.params, rows)
    assert serve_cfg.algo.name == "ppo_sebulba" and acts.shape == (3, 1)


def test_torch_sebulba_ppo_many_actors_small_queue_and_env_groups(tmp_path):
    """3 actors on a queue of one, publishing every 2 updates; then one actor
    slicing 3 groups: the learner's item shape and count are env_groups 1's."""
    crowded = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/a", "algo.total_steps=128", "checkpoint.every=0",
                                      "checkpoint.save_last=false", "algo.sebulba.num_actor_threads=3",
                                      "algo.sebulba.queue_depth=1", "algo.sebulba.publish_every=2"])
    pipe = crowded["pipeline"]
    assert crowded["iterations"] == 8 and pipe["Pipeline/max_queue_depth"] <= 1
    assert pipe["Pipeline/actor_stall_s"] > 0 and pipe["staleness_bound"] == 3
    assert pipe["Pipeline/publishes"] == 1 + 8 // 2
    grouped = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}/b", "algo.total_steps=128", "checkpoint.every=0",
                                      "checkpoint.save_last=false", "algo.sebulba.num_actor_threads=1",
                                      "algo.sebulba.env_groups=3"])
    assert grouped["iterations"] == 8 and grouped["policy_steps"] == 128
    assert grouped["pipeline"]["staleness_bound"] == 2 + 3 + 1
    assert len(grouped["losses"]) == 8 and np.isfinite(np.asarray(grouped["losses"])).all()


def test_torch_sebulba_ppo_continuous(tmp_path):
    out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "env.id=continuous_dummy", "dry_run=true",
                                  "checkpoint.save_last=false"])
    assert out["iterations"] == 1 and np.isfinite(np.asarray(out["losses"])).all()


def test_torch_sebulba_ppo_killed_actor_restarts(tmp_path):
    inject.arm("ppo_sebulba.actor2.step", action="kill-thread", at=12)
    with pytest.warns(UserWarning, match="sebulba-actor-2.*restarting"):
        out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "algo.total_steps=96", "checkpoint.every=0",
                                      "checkpoint.save_last=false", "algo.sebulba.num_actor_threads=3",
                                      "fault.supervisor.backoff=0.0"])
    pipe = out["pipeline"]
    assert pipe["Pipeline/actor_deaths"] == 1 and pipe["Pipeline/actor_restarts"] == 1
    assert pipe["Pipeline/actors_live"] == 3 and out["iterations"] == 6


def test_torch_sebulba_ppo_hung_actor_degrades_the_pool(tmp_path):
    """Actor 0 goes silent at its 3rd step; past its 2 s lease the
    supervisor abandons it and, with no restart budget, the other two carry
    the run (long enough, 300 iterations, for the lease to expire; a healthy
    actor beats every env step, so 2 s of silence is far past a loaded
    host's scheduling delay)."""
    inject.arm("ppo_sebulba.actor0.step", action="hang", at=3, hang_s=60.0)
    try:
        with pytest.warns(UserWarning, match="hung"):
            out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "algo.total_steps=4800", "checkpoint.every=0",
                                          "checkpoint.save_last=false", "algo.sebulba.num_actor_threads=3",
                                          "fault.supervisor.max_restarts=0", "fault.supervisor.lease_s=2.0",
                                          "fault.supervisor.grace_s=2.0", "fault.supervisor.join_s=1.0"])
    finally:
        inject.release_hangs()
    pipe = out["pipeline"]
    assert pipe["Pipeline/actor_hangs"] == 1 and pipe["Pipeline/actors_degraded"] == 1
    assert pipe["Pipeline/actors_live"] == 2 and out["iterations"] == 300


def test_torch_sebulba_ppo_zero_survivors_abort_typed(tmp_path):
    inject.arm("ppo_sebulba.actor0.step", action="raise", at=3)
    with pytest.warns(UserWarning):
        with pytest.raises(AllWorkersDeadError, match="sebulba-actor-0"):
            cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "algo.total_steps=96", "checkpoint.every=0",
                                    "algo.sebulba.num_actor_threads=1", "fault.supervisor.max_restarts=0"])


def test_torch_sebulba_ppo_rollback_republishes(tmp_path):
    """One actor poisons its 3rd rollout's advantages; the guarded update
    skips, the sentinel (max_consecutive 1) rolls back to the last save and
    the learner publishes again, so actors never act on diverged weights."""
    out = cli.run(SEBULBA_FAST + [f"log_root={tmp_path}", "algo.total_steps=96", "checkpoint.every=16",
                                  "algo.sebulba.num_actor_threads=1", "fault.inject.nan_grads_at=[3]",
                                  "fault.sentinel.max_consecutive=1"])
    assert out["rollbacks"] == 1 and out["Fault/skipped_updates"] > 0
    assert out["pipeline"]["Pipeline/publishes"] == 1 + out["iterations"] + out["rollbacks"]
    assert np.isfinite(np.asarray(out["losses"])[[i for i, s in enumerate(out["skipped"]) if s == 0]]).all()


def test_torch_sebulba_ppo_decoupled_trains_checkpoints_resumes_and_evaluates(tmp_path):
    fast = ["preset=ppo_decoupled", "fabric.accelerator=cpu", "env.id=discrete_dummy", "env.num_envs=2",
            "metric.log_level=0", "algo.run_test=false", "algo.rollout_steps=8", "buffer.size=8",
            "algo.per_rank_batch_size=4", "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]"]
    first = cli.run(fast + [f"log_root={tmp_path}/a", "algo.total_steps=64", "checkpoint.every=32"])
    assert first["iterations"] == 4 and first["policy_steps"] == 64 and np.isfinite(np.asarray(first["losses"])).all()
    ckpts = _ckpts(f"{tmp_path}/a")
    assert [os.path.basename(c) for c in ckpts] == ["ckpt_32_0.ckpt", "ckpt_64_0.ckpt"]  # the player's, the trainer's
    assert load_checkpoint(ckpts[0])["iter_num"] == 2
    resumed = cli.run(fast + [f"checkpoint.resume_from={ckpts[0]}", f"log_root={tmp_path}/b"])
    assert resumed["start_iter"] == 3 and resumed["iterations"] == 2 and resumed["policy_steps"] == 64
    assert torch.equal(load_checkpoint(_ckpts(f"{tmp_path}/b")[-1])["rng"], load_checkpoint(ckpts[1])["rng"])
    assert cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])["steps"] > 0


def test_torch_sebulba_ppo_registered_and_needs_a_card(monkeypatch, capsys):
    from sheeprl_tpu_torch.utils.registry import TRAINERS

    rows = {r["name"]: r for r in cli.agents()}
    assert "ppo_sebulba: trainer=sheeprl_tpu_torch.algos.ppo.ppo_sebulba, evaluation=True, serving=True, " \
           "decoupled=True" in capsys.readouterr().out
    for name in ("ppo_decoupled", "ppo_sebulba", "sac_decoupled", "sac_sebulba"):
        assert rows[name]["trainer"] == TRAINERS[name] and rows[name]["decoupled"]
        assert rows[name]["evaluation"] and rows[name]["serving"]
        importlib.import_module(TRAINERS[name])
    assert not rows["ppo"]["decoupled"] and not rows["sac"]["decoupled"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("ppo_decoupled", "ppo_sebulba", "sac_decoupled", "sac_sebulba", "sac_sebulba_per"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run([f"preset={name}"])
