"""One data-parallel SAC train call of the port (2 gloo rank processes)
against the JAX package's on a 2-device CPU mesh, on the CPU, for the host
buffer's step, the uniform device ring and the replicated prioritized ring.

The size of ``tests/test_torch_sac_update.py`` (hidden 32, Pendulum's 3
observations and 1 torque, 2 critics), a global batch of 16: each rank, as
each JAX device, trains on 8 rows a step, 2 steps a call.

- host step (``make_train_step``): rank ``r`` takes rows ``8 r .. 8 r + 7``
  of the ``(2, 16)`` sample, JAX's device ``r`` the same shard;
- uniform ring (``make_resident_train_step``): JAX's env-sharded ring of 4
  envs x 64 rows holding 23 rows (``shard_envs``, 2 env columns a device);
  port rank ``r`` holds JAX device ``r``'s 2 columns, one staged row is
  appended on each, and each draws its own ``(pos, env)`` rows;
- prioritized ring: JAX's replicated ring of the group's 4 envs with random
  priorities and ``max_p`` 3; each port rank holds the whole ring, appends
  every rank's staged row in rank order, draws its 8 leaves through
  ``sumtree_sample`` from the common tree, normalises the weights by the
  group's largest and applies both ranks' leaves and priorities in rank order.

Both sides start from the same flax weights and fresh Adams; the port is fed
JAX's draws, rebuilt from each device's key (``fold_in`` of the device index).
Cases run at the float32 and the bfloat16 wire, some with the guard on; one
more guarded case poisons rank 1's rewards with NaN: both ranks skip both
steps, as JAX's devices do, and nothing deadlocks. The two ranks spawn once
for the file and run every case.

Tolerances: at the float32 wire the three mean losses within rtol 1e-5
(atol 1e-6), every parameter within 1e-5, the sum-tree and ``max_p`` within
1e-5 and the rings' storage exactly (``tests/test_torch_sac_update.py``'s).
At the bfloat16 wire each averaged gradient is the bfloat16 rounding of the
mean on both sides, and an element one float32 rounding away from a bfloat16
boundary may round one bfloat16 ulp (2^-8 relative) apart; an Adam step
moves a parameter by at most its learning rate, so the parameters are held
within 1e-5 + 2 steps x lr x 2^-8, the losses within rtol 1e-4 (the second
step reads those parameters), the tree within 1e-4. The two ranks'
parameters, and for PER their rings, trees and ``max_p``, are bit-equal in
every case.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.sac import make_resident_train_step as jax_resident_step
from sheeprl_tpu.algos.sac.sac import make_train_step as jax_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.replay import DeviceReplayBuffer as JaxDeviceReplayBuffer
from sheeprl_tpu.replay import sumtree as jst
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax
from tests.torch_dp_ranks import offpolicy_job, spawn_ranks

HIDDEN, BATCH, WORLD, G, OBS, ACT = 32, 16, 2, 2, 3, 1
LOCAL = BATCH // WORLD
CAP, ENVS, FILLED = 64, 4, 23  # the JAX ring's envs: 2 a rank
SPECS = {"observations": ((OBS,), np.float32), "next_observations": ((OBS,), np.float32),
         "actions": ((ACT,), np.float32), "rewards": ((1,), np.float32), "terminated": ((1,), np.float32)}
ACTION_SPACE = {"shape": [ACT], "low": [-2.0], "high": [2.0]}
OVERRIDES = [f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={BATCH}", f"env.num_envs={ENVS // WORLD}"]
CASES = {
    "host-f32": dict(kind="sac_host", wire="float32", guard=False),
    "host-bf16-guarded": dict(kind="sac_host", wire="bfloat16", guard=True),
    "host-nan-on-rank1-guarded": dict(kind="sac_host", wire="float32", guard=True, poison=True),
    "uniform-ring-f32-guarded": dict(kind="sac_resident", wire="float32", guard=True, prioritized=False),
    "uniform-ring-bf16": dict(kind="sac_resident", wire="bfloat16", guard=False, prioritized=False),
    "per-ring-f32-guarded": dict(kind="sac_resident", wire="float32", guard=True, prioritized=True),
    "per-ring-bf16": dict(kind="sac_resident", wire="bfloat16", guard=False, prioritized=True),
}


def _rows(rng, lead):
    return {
        "observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "next_observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(*lead, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(*lead, 1)) < 0.2).astype(np.float32),
    }


def _host_case(c, jagent, txs, opts, params, cfg, mesh, rng):
    data = _rows(rng, (G, BATCH))
    if c.get("poison"):
        data["rewards"][:, LOCAL:] = np.nan  # rank 1's rows only
    key = jax.random.PRNGKey(11)
    step = jax_train_step(jagent, *txs, cfg, mesh, donate=False, guard=c["guard"])
    out = step(params, *opts, {k: jnp.asarray(v) for k, v in data.items()}, key, jnp.float32(1.0))
    noise = {"next": [], "actor": []}
    for d in range(WORLD):
        per = {"next": [], "actor": []}
        for k in jax.random.split(jax.random.fold_in(key, d), G):
            k_next, k_actor = jax.random.split(k)
            per["next"].append(np.asarray(jax.random.normal(k_next, (LOCAL, ACT))))
            per["actor"].append(np.asarray(jax.random.normal(k_actor, (LOCAL, ACT))))
        for name in noise:
            noise[name].append(np.stack(per[name]))
    port = {"data": data, "noise": {k: np.stack(v) for k, v in noise.items()}, "ema": True, "local_batch": LOCAL}
    want = {"params": out[0], "losses": [float(x) for x in out[4:7]],
            "skipped": float(out[7]) if c["guard"] else 0.0}
    return port, want


def _ring_case(c, jagent, txs, opts, params, cfg, fabric, rng):
    prioritized = c["prioritized"]
    jdrb = JaxDeviceReplayBuffer(
        fabric, {k: (s, jnp.float32) for k, (s, _) in SPECS.items()}, CAP, ENVS, prioritized=prioritized,
        per_alpha=0.6, per_eps=1e-6, shard_envs=not prioritized,
        extra_spec=[("__flags__", (G,), np.float32), ("__valid__", (G,), np.float32), ("__beta__", (), np.float32)],
        seed=29,
    )
    append = jdrb.make_append_step(donate=False)
    for _ in range(FILLED):
        jdrb.state = append(jdrb.state, jnp.asarray(jdrb.pack_rows([{k: v[0] for k, v in _rows(rng, (1, ENVS)).items()}])))
        jdrb.note_append(1)
    if prioritized:
        leaves = np.arange(FILLED * ENVS)
        jdrb.state["tree"] = jst.update(jdrb.state["tree"], jnp.asarray(leaves),
                                        jnp.asarray(rng.uniform(0.05, 2.0, size=leaves.shape).astype(np.float32)))
        jdrb.state["max_p"] = jnp.float32(3.0)
    ring = {"capacity": CAP, "pos": FILLED, "storage": {k: np.array(v) for k, v in jdrb.state["storage"].items()}}
    if prioritized:
        ring["tree"], ring["max_p"] = np.array(jdrb.state["tree"]), float(jdrb.state["max_p"])
    key = jnp.asarray(np.asarray(jdrb.state["key"]))
    row = _rows(rng, (1, ENVS))
    beta, flags = 0.55, [1.0, 1.0]
    jdrb.add(row)
    blob = jdrb.make_job({"__flags__": np.ones(G, np.float32), "__valid__": np.ones(G, np.float32),
                          "__beta__": np.float32(beta)})
    step = jax_resident_step(jagent, *txs, cfg, fabric.mesh, jdrb, G, guard=c["guard"], donate=False)
    out = step(params, *opts, jdrb.state, blob)

    # each device's draws: split the ring key, fold in the device, one key a step split in four
    _, sub = jax.random.split(key)
    draws = {"u": [], "pos": [], "env": [], "next": [], "actor": []}
    for d in range(WORLD):
        per = {k: [] for k in draws}
        for k in jax.random.split(jax.random.fold_in(sub, d), G):
            k_a, k_b, k_next, k_actor = jax.random.split(k, 4)
            per["u"].append(np.asarray(jax.random.uniform(k_a, (LOCAL,))))
            per["pos"].append(np.asarray(jax.random.randint(k_a, (LOCAL,), 0, FILLED + 1)).astype(np.int64))
            per["env"].append(np.asarray(jax.random.randint(k_b, (LOCAL,), 0, ENVS // WORLD)).astype(np.int64))
            per["next"].append(np.asarray(jax.random.normal(k_next, (LOCAL, ACT))))
            per["actor"].append(np.asarray(jax.random.normal(k_actor, (LOCAL, ACT))))
        for name in draws:
            draws[name].append(np.stack(per[name]))
    keep = ("u",) if prioritized else ("pos", "env")
    draws = {k: np.stack(v) for k, v in draws.items() if k in keep + ("next", "actor")}
    port = {"ring": ring, "row": row, "draws": draws, "flags": flags, "beta": beta, "specs": SPECS,
            "prioritized": prioritized, "envs_per_rank": ENVS // WORLD}
    state = out[4]
    want = {"params": out[0], "losses": [float(x) for x in out[5:8]], "skipped": float(out[8]),
            "storage": {k: np.asarray(v) for k, v in state["storage"].items()}}
    if prioritized:
        want["tree"], want["max_p"] = np.asarray(state["tree"]), float(state["max_p"])
    return port, want


@pytest.fixture(scope="module")
def calls():
    cfg = compose(["exp=sac"] + OVERRIDES)
    port_cfg = plain(apply_overrides(preset("sac"), OVERRIDES + [f"algo.actor.hidden_size={HIDDEN}",
                                                                  f"algo.critic.hidden_size={HIDDEN}"]))
    fabric = Fabric(devices=WORLD, accelerator="cpu")
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32)
    jagent, params, _ = jax_build_agent(fabric, cfg, obs_space, act_space)
    before = sac_state_from_jax(jax.tree.map(np.asarray, params))
    txs = [jax_build_optimizer(cfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")]
    lrs = [float(cfg.algo[k].optimizer.lr) for k in ("actor", "critic", "alpha")]
    cases, want = {}, {}
    rng = np.random.default_rng(5)
    for name, c in CASES.items():
        opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
        jax_comm.set_grad_reduce_dtype(c["wire"], fresh_run=True)
        try:
            if c["kind"] == "sac_host":
                port, want[name] = _host_case(c, jagent, txs, opts, params, cfg, fabric.mesh, rng)
            else:
                port, want[name] = _ring_case(c, jagent, txs, opts, params, cfg, fabric, rng)
        finally:
            jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)
        want[name]["params"] = sac_state_from_jax(jax.tree.map(np.asarray, want[name]["params"]))
        cases[name] = dict(c, **port, cfg=port_cfg, state=before, obs_dim=OBS, action_space=ACTION_SPACE)
    exact = np.random.default_rng(9)
    cases["exact-bf16-wire"] = {
        "kind": "exact", "wire": "bfloat16", "values": exact.normal(size=(WORLD, 5)).astype(np.float32),
        "leaves": exact.integers(0, 2 ** 40, size=(WORLD, LOCAL)).astype(np.int64),
        "prios": (exact.uniform(size=(WORLD, LOCAL)) + 1e-3).astype(np.float32),
        "flags": [[True, True], [True, False], [False, False]],
    }
    ranks = spawn_ranks(offpolicy_job, {"cases": cases}, world=WORLD, timeout=240.0)
    return {"ranks": ranks, "jax": want, "before": before, "lr": max(lrs), "cases": cases}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_offpolicy_sac_ranks_end_bit_equal(calls, case):
    a, b = (r[case] for r in calls["ranks"])
    assert a["digest"] == b["digest"]
    for name, value in a["params"].items():
        assert np.array_equal(value, b["params"][name]), name
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert a["skipped"] == b["skipped"]
    # critic, actor and alpha: three reductions a step, the verdict riding the last
    assert a["reductions"] == b["reductions"] == 3 * G
    if CASES[case]["kind"] == "sac_resident" and CASES[case]["prioritized"]:
        assert a["ring_digest"] == b["ring_digest"]
        np.testing.assert_array_equal(a["tree"], b["tree"])
        assert a["max_p"] == b["max_p"]


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_offpolicy_sac_matches_jax(calls, case):
    c = CASES[case]
    got, want = calls["ranks"][0][case], calls["jax"][case]
    bf16 = c["wire"] == "bfloat16"
    assert got["skipped"] == want["skipped"] == (float(G) if c.get("poison") else 0.0)
    if c.get("poison"):
        # both ranks skipped both steps: the parameters are the starting ones, as JAX's
        for name, value in calls["before"].items():
            np.testing.assert_array_equal(got["params"][name], value.numpy(), err_msg=name)
            np.testing.assert_array_equal(want["params"][name].numpy(), value.numpy(), err_msg=name)
        return
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4 if bf16 else 1e-5, atol=1e-6)
    atol = 1e-5 + (G * calls["lr"] * 2.0 ** -8 if bf16 else 0.0)
    moved = 0
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value.numpy(), atol=atol, rtol=0, err_msg=name)
        moved += int(not np.array_equal(value.numpy(), calls["before"][name].numpy()))
    assert moved > 0
    if c["kind"] == "sac_resident":
        rank_cols = slice(0, ENVS // WORLD)  # rank 0's columns of JAX's sharded ring, or the whole replicated one
        for k in SPECS:
            want_k = want["storage"][k] if c["prioritized"] else want["storage"][k][:, rank_cols]
            np.testing.assert_array_equal(got["storage"][k], want_k, err_msg=k)
        if c["prioritized"]:
            tol = 1e-4 if bf16 else 1e-5
            np.testing.assert_allclose(got["tree"], want["tree"], atol=tol, rtol=tol)
            np.testing.assert_allclose(got["max_p"], want["max_p"], rtol=tol)


def test_torch_dp_offpolicy_sac_differs_from_one_device(calls):
    """The reduction is real: one process stepping alone on rank 0's rows,
    with rank 0's draws, ends elsewhere."""
    import torch

    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers, make_train_step
    from sheeprl_tpu_torch.config import dotdict

    case = calls["cases"]["host-f32"]
    cfg = dotdict(case["cfg"])
    agent, _ = build_agent(cfg, OBS, ACTION_SPACE, "cpu", calls["before"])
    data = {k: torch.from_numpy(np.ascontiguousarray(v[:, :LOCAL])) for k, v in case["data"].items()}
    noise = {k: torch.from_numpy(v[0]) for k, v in case["noise"].items()}
    make_train_step(agent, make_optimizers(cfg, agent), cfg)(data, True, noise=noise)
    dp = calls["ranks"][0]["host-f32"]["params"]
    assert any(not np.array_equal(v.numpy(), dp[k]) for k, v in agent.state_dict().items())


def test_torch_dp_offpolicy_exact_collectives_round_nothing(calls):
    """The weight maximum, the group's AND and the gather of leaves (int64
    past 2^32) and priorities (float32) are exact under the bfloat16 wire,
    every rank gets the same, in rank order."""
    c = calls["cases"]["exact-bf16-wire"]
    for r in calls["ranks"]:
        got = r["exact-bf16-wire"]
        np.testing.assert_array_equal(got["max"], c["values"].max(axis=0))
        assert got["all_true"] == [True, False, False]
        np.testing.assert_array_equal(got["leaves"], c["leaves"].reshape(-1))
        np.testing.assert_array_equal(got["prios"], c["prios"].reshape(-1))
        assert got["dtypes"] == ["torch.int64", "torch.float32"]
        assert got["reductions"] == 0  # none of them is a gradient reduction


def test_torch_dp_offpolicy_one_process_collectives_are_identities():
    import torch

    from sheeprl_tpu_torch.parallel import comm

    before = dict(comm.REDUCTIONS)
    x = torch.arange(4.0)
    leaves, prios = torch.arange(3), torch.ones(3)
    assert comm.all_reduce_max(x) is x and comm.all_true(True) and not comm.all_true(False)
    got = comm.all_gather_exact(leaves, prios)
    assert got[0] is leaves and got[1] is prios and comm.REDUCTIONS == before
