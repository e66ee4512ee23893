"""One data-parallel PPO update of the port (2 gloo rank processes,
``make_train_step`` with ``pmean_grads``) against the JAX package's
``make_train_step`` on a 2-device CPU mesh, on the CPU.

The shape of ``tests/test_torch_ppo_update.py``'s first case, split over two
ranks: 4 envs x 16 steps (64 rows; rank ``r`` and device ``r`` hold rows
``32 r`` to ``32 r + 31``), 2 epochs of minibatches of 8 per rank (4 a rank
and epoch, 8 Adam steps), entropy coefficient 0.01. ``buffer.share_data``
off: each rank permutes its own 32 rows with JAX's ``fold_in(key, rank)``
permutations; on: every rank gathers the 64 rows and takes its slice of
JAX's common permutation of them. Both sides start from the same flax
weights and a fresh Adam. The guard is on in half the cases (the verdict
rides the all-reduce).

Tolerances: at the float32 wire the losses within rtol 1e-5 and every
parameter within atol 1e-6; at the bfloat16 wire each averaged gradient is
the bfloat16 rounding of the mean, so a gradient element one float32 ulp
from a bfloat16 boundary may round one bfloat16 ulp apart on the two sides:
one Adam step moves a parameter by at most the learning rate (1e-3), and a
one-ulp relative change (2^-8) of its gradient moves that step by at most
2^-8 of it, so the parameters are held within 8 steps x 1e-3 x 2^-8
(3.1e-5), the losses within rtol 1e-5 as before. The two ranks' parameters
are bit-equal in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax
from tests.torch_dp_ranks import ppo_update_job, spawn_ranks

N_ENVS, T, EPOCHS, MB, WORLD = 4, 16, 2, 8, 2
ROWS = N_ENVS * T
LOCAL = ROWS // WORLD
STEPS = EPOCHS * (LOCAL // MB)
LR = 1e-3
CASES = {
    "own-rows-f32": dict(share=False, wire="float32", guard=False),
    "shared-rows-f32-guarded": dict(share=True, wire="float32", guard=True),
    "own-rows-bf16-guarded": dict(share=False, wire="bfloat16", guard=True),
    "shared-rows-bf16": dict(share=True, wire="bfloat16", guard=False),
}


def _overrides(c):
    return [f"env.num_envs={N_ENVS}", f"algo.rollout_steps={T}", f"algo.per_rank_batch_size={MB}",
            f"algo.update_epochs={EPOCHS}", f"buffer.share_data={c['share']}"]


def _data(seed):
    rng = np.random.default_rng(seed)
    return {
        "state": rng.normal(size=(ROWS, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, ROWS)],
        "logprobs": (np.log(0.5) + 0.2 * rng.normal(size=(ROWS, 1))).astype(np.float32),
        "values": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "returns": (rng.normal(size=(ROWS, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "rewards": np.ones((ROWS, 1), np.float32),
        "dones": (rng.uniform(size=(ROWS, 1)) < 0.1).astype(np.uint8),
    }


def jax_dp_permutations(key, share):
    """``make_local_train``'s per-epoch permutations on each device of a
    2-device mesh: ``(WORLD, EPOCHS, LOCAL)``, indices into the device's own
    rows, or with ``share`` into the gathered rows."""
    out = []
    for d in range(WORLD):
        if share:
            perms = [np.asarray(jax.random.permutation(k, ROWS))[d * LOCAL:(d + 1) * LOCAL]
                     for k in jax.random.split(key, EPOCHS)]
        else:
            perms = [np.asarray(jax.random.permutation(k, LOCAL))
                     for k in jax.random.split(jax.random.fold_in(key, d), EPOCHS)]
        out.append(np.stack(perms))
    return np.stack(out)


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    c = CASES[request.param]
    cfg = compose(["exp=ppo"] + _overrides(c))
    port_cfg = apply_overrides(preset("ppo"), _overrides(c))
    assert float(cfg.algo.optimizer.lr) == float(port_cfg.algo.optimizer.lr) == LR
    jax_agent = JaxPPOAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                            encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                            critic_cfg=dict(cfg.algo.critic))
    params = jax_agent.init(jax.random.PRNGKey(0), {"state": jnp.zeros((1, 4), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = optax.inject_hyperparams(lambda learning_rate: jax_build_optimizer(
        {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm))(learning_rate=LR)
    mesh = Fabric(devices=WORLD, accelerator="cpu").mesh
    data = _data(1)
    key = jax.random.PRNGKey(3)
    jax_comm.set_grad_reduce_dtype(c["wire"], fresh_run=True)
    try:
        train = jax_make_train_step(jax_agent, tx, cfg, mesh, LOCAL, donate=False, guard=c["guard"])
        out = train(params, tx.init(params), data, key, jnp.float32(0.2), jnp.float32(0.01))
        jax.block_until_ready(out)
    finally:
        jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)
    port = spawn_ranks(ppo_update_job, {
        "wire": c["wire"], "cfg": plain(port_cfg), "state": ppo_state_from_jax(before), "local_rows": LOCAL,
        "data": data, "perms": jax_dp_permutations(key, c["share"]), "guard": c["guard"],
    })
    return {
        "case": c, "port": port, "before": ppo_state_from_jax(before),
        "jax": {"losses": [float(x) for x in out[2:5]], "skipped": float(out[5]) if c["guard"] else 0.0,
                "params": ppo_state_from_jax(jax.tree.map(np.asarray, out[0]))},
    }


def test_torch_dp_ppo_update_ranks_end_bit_equal(update):
    a, b = update["port"]
    assert a["digest"] == b["digest"]
    for name, value in a["params"].items():
        assert np.array_equal(value, b["params"][name]), name
    np.testing.assert_array_equal(a["losses"], b["losses"])
    # one all-reduce per minibatch (the guard's verdict rides it), STEPS of them
    assert a["calls"] == b["calls"] == STEPS


def test_torch_dp_ppo_update_losses_match_jax(update):
    for rank in range(WORLD):
        got = update["port"][rank]["losses"]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, update["jax"]["losses"], rtol=1e-5, atol=1e-7)
        assert update["port"][rank]["skipped"] == update["jax"]["skipped"] == 0.0


def test_torch_dp_ppo_update_params_match_jax(update):
    atol = 1e-6 if update["case"]["wire"] == "float32" else STEPS * LR * 2.0 ** -8
    want = update["jax"]["params"]
    got = update["port"][0]["params"]
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value.numpy(), atol=atol, rtol=0, err_msg=name)
        assert not np.array_equal(value.numpy(), update["before"][name].numpy()), name  # every tensor moved


def test_torch_dp_ppo_update_differs_from_one_device(update):
    """The reduction is real: one process stepping alone on rank 0's rows,
    with rank 0's own permutations, ends elsewhere."""
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step

    port_cfg = apply_overrides(preset("ppo"), _overrides(dict(update["case"], share=False)))
    agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", update["before"])
    train = make_train_step(agent, make_optimizer(port_cfg, agent), port_cfg, LOCAL)
    perms = jax_dp_permutations(jax.random.PRNGKey(3), False)[0]
    train({k: torch.from_numpy(v[:LOCAL]) for k, v in _data(1).items()}, 0.2, 0.01, perms=torch.from_numpy(perms))
    alone = agent.state_dict()
    assert any(not np.array_equal(alone[k].numpy(), v) for k, v in update["port"][0]["params"].items())
