"""One data-parallel A2C update and one data-parallel recurrent PPO update
of the port (2 gloo rank processes) against the JAX package's
``make_train_step`` on a 2-device CPU mesh, on the CPU, at the float32 and
the bfloat16 wire.

**A2C** (``tests/test_torch_a2c_update.py``'s recipe case over two ranks): 4
envs x 5 steps, rank ``r`` holding rows ``10 r`` to ``10 r + 9``, minibatches
of 5, the summed gradients mean-reduced over the ranks, one clipped RMSprop
step; each rank permutes its own rows with JAX's ``fold_in(key, rank)``
permutation.

**Recurrent PPO** (``tests/test_torch_ppo_recurrent_update.py``'s rollout
over two ranks): 4 envs x 32 steps, rank ``r`` stepping envs ``2 r`` and
``2 r + 1``; each rank gathers the group's rollout (``gather_envs``), chunks
it into sequences of 8, pads their count to ``bucket(S, 2 x 2)`` and takes
its contiguous half (``prepare_update``), as JAX shards the padded sequences
over ``dp``; 2 epochs x 2 minibatches with JAX's ``fold_in(key, rank)``
permutations.

Tolerances: at the float32 wire the losses within rtol 1e-5 and every
parameter within atol 1e-6; at the bfloat16 wire a gradient element may
round one bfloat16 ulp apart on the two sides (see
``tests/test_torch_dp_ppo_update.py``), so the parameters are held within
steps x (the largest move of one step) x 2^-8: RMSprop's first step moves a
parameter by at most lr / sqrt(1 - alpha) = 1e-2 (A2C: 1 step, 3.9e-5),
Adam's by its lr 3e-4 (recurrent: 4 steps, 4.7e-6). The ranks' parameters are
bit-equal in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sheeprl_tpu.algos.a2c.a2c import make_train_step as jax_a2c_train_step
from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo_recurrent.agent import RecurrentPPOAgent as JaxRecurrentAgent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import _bucket as jax_bucket
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_train_step as jax_recurrent_train_step
from sheeprl_tpu.algos.ppo_recurrent.utils import chunk_sequences as jax_chunk_sequences
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.utils.convert import a2c_state_from_jax, ppo_recurrent_state_from_jax
from tests.test_torch_ppo_recurrent_update import rollout
from tests.torch_dp_ranks import a2c_update_job, recurrent_update_job, spawn_ranks

WORLD = 2
WIRES = ["float32", "bfloat16"]


def _mesh():
    return Fabric(devices=WORLD, accelerator="cpu").mesh


def _jax_step(wire, build, *args):
    """Build and run a JAX step at ``wire``, leaving JAX's wire at float32."""
    jax_comm.set_grad_reduce_dtype(wire, fresh_run=True)
    try:
        out = build()(*args)
        return jax.block_until_ready(out)
    finally:
        jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)


def _fold_in_perms(key, n, epochs=None):
    """Each device's permutations of its own ``n`` rows: ``(WORLD, n)``, or
    ``(WORLD, epochs, n)`` split per epoch."""
    out = []
    for d in range(WORLD):
        k = jax.random.fold_in(key, d)
        if epochs is None:
            out.append(np.asarray(jax.random.permutation(k, n)))
        else:
            out.append(np.stack([np.asarray(jax.random.permutation(e, n)) for e in jax.random.split(k, epochs)]))
    return np.stack(out)


def _close(got, want, atol):
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value.numpy(), atol=atol, rtol=0, err_msg=name)


# -- A2C ---------------------------------------------------------------------------

A2C_ROWS, A2C_MB = 20, 5
A2C_LOCAL = A2C_ROWS // WORLD


def _a2c_data(seed):
    rng = np.random.default_rng(seed)
    return {
        "state": rng.normal(size=(A2C_ROWS, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, A2C_ROWS)],
        "values": rng.normal(size=(A2C_ROWS, 1)).astype(np.float32),
        "returns": (rng.normal(size=(A2C_ROWS, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(A2C_ROWS, 1)).astype(np.float32),
        "rewards": np.ones((A2C_ROWS, 1), np.float32),
        "dones": (rng.uniform(size=(A2C_ROWS, 1)) < 0.1).astype(np.uint8),
    }


@pytest.fixture(scope="module", params=WIRES)
def a2c(request):
    wire = request.param
    over = [f"algo.per_rank_batch_size={A2C_MB}", "algo.loss_reduction=sum"]
    cfg = compose(["exp=a2c"] + over)
    port_cfg = apply_overrides(preset("a2c"), over)
    agent = JaxPPOAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                        encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                        critic_cfg=dict(cfg.algo.critic))
    params = jax.tree.map(np.asarray, agent.init(jax.random.PRNGKey(1), {"state": jnp.zeros((1, 4), jnp.float32)}))
    tx = jax_build_optimizer(cfg.algo.optimizer, max_grad_norm=cfg.algo.max_grad_norm)
    data, key = _a2c_data(2), jax.random.PRNGKey(5)
    new_params, _, pg, v = _jax_step(wire, lambda: jax_a2c_train_step(agent, tx, cfg, _mesh(), A2C_LOCAL),
                                     jax.tree.map(jnp.asarray, params), tx.init(params), data, key)
    port = spawn_ranks(a2c_update_job, {
        "wire": wire, "cfg": plain(port_cfg), "dims": (2,), "state": a2c_state_from_jax(params),
        "local_rows": A2C_LOCAL, "data": data, "perms": _fold_in_perms(key, A2C_LOCAL),
    })
    lr, alpha = float(cfg.algo.optimizer.lr), float(cfg.algo.optimizer.alpha)
    return {"wire": wire, "port": port, "losses": [float(pg), float(v)],
            "params": a2c_state_from_jax(jax.tree.map(np.asarray, new_params)), "step": lr / np.sqrt(1 - alpha)}


def test_torch_dp_a2c_recurrent_a2c_matches_jax(a2c):
    a, b = a2c["port"]
    assert a["digest"] == b["digest"]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_allclose(a["losses"], a2c["losses"], rtol=1e-5, atol=1e-7)
    _close(a["params"], a2c["params"], 1e-6 if a2c["wire"] == "float32" else a2c["step"] * 2.0 ** -8)


# -- recurrent PPO -----------------------------------------------------------------

N_ENVS, T, SEQ, NB, EPOCHS, H = 4, 32, 8, 2, 2, 64


def _jax_padded(data):
    """The JAX loop's chunking and padding of the whole rollout, quantum
    ``WORLD * NB`` (``ppo_recurrent.py``'s main)."""
    padded, mask = jax_chunk_sequences(data, T, N_ENVS, SEQ)
    s = mask.shape[1]
    s_pad = jax_bucket(s, WORLD * NB)
    padded = {k: np.concatenate([v, np.zeros((SEQ, s_pad - s, *v.shape[2:]), v.dtype)], axis=1)
              for k, v in padded.items()}
    padded["mask"] = np.concatenate([mask, np.zeros((SEQ, s_pad - s), mask.dtype)], axis=1)
    padded["prev_hx"], padded["prev_cx"] = padded["prev_hx"][:1], padded["prev_cx"][:1]
    return padded, s_pad


@pytest.fixture(scope="module", params=WIRES)
def recurrent(request):
    wire = request.param
    over = [f"env.num_envs={N_ENVS}", f"algo.rollout_steps={T}", f"algo.per_rank_sequence_length={SEQ}",
            f"algo.per_rank_num_batches={NB}", f"algo.update_epochs={EPOCHS}"]
    cfg = compose(["exp=ppo_recurrent"] + over)
    port_cfg = apply_overrides(preset("ppo_recurrent"), over)
    agent = JaxRecurrentAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                              encoder_cfg=dict(cfg.algo.encoder), rnn_cfg=dict(cfg.algo.rnn),
                              actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic))
    z = jnp.zeros((1, H))
    params = jax.tree.map(np.asarray, agent.init(jax.random.PRNGKey(3), {"state": jnp.zeros((1, 1, 4))},
                                                 jnp.zeros((1, 1, 2)), z, z))
    lr = float(cfg.algo.optimizer.lr)
    tx = optax.inject_hyperparams(lambda learning_rate: jax_build_optimizer(
        {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm))(learning_rate=lr)
    data = rollout(5)
    padded, s_pad = _jax_padded(data)
    s_local = s_pad // WORLD
    key = jax.random.PRNGKey(9)
    new_params, _, pg, v, ent = _jax_step(
        wire, lambda: jax_recurrent_train_step(agent, tx, cfg, _mesh(), s_local),
        jax.tree.map(jnp.array, params), tx.init(params), padded, key, jnp.float32(0.2), jnp.float32(0.001))
    port = spawn_ranks(recurrent_update_job, {
        "wire": wire, "cfg": plain(port_cfg), "state": ppo_recurrent_state_from_jax(params), "rollout": data,
        "envs_per_rank": N_ENVS // WORLD, "T": T, "seq": SEQ, "nb": NB,
        "perms": _fold_in_perms(key, s_local, EPOCHS),
    })
    return {"wire": wire, "port": port, "losses": [float(pg), float(v), float(ent)], "s_local": s_local,
            "params": ppo_recurrent_state_from_jax(jax.tree.map(np.asarray, new_params)), "step": lr}


def test_torch_dp_a2c_recurrent_recurrent_matches_jax(recurrent):
    a, b = recurrent["port"]
    assert a["s_local"] == b["s_local"] == recurrent["s_local"]  # each rank its half of the padded sequences
    assert a["digest"] == b["digest"]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    np.testing.assert_allclose(a["losses"], recurrent["losses"], rtol=1e-5, atol=1e-7)
    steps = EPOCHS * NB
    _close(a["params"], recurrent["params"],
           1e-6 if recurrent["wire"] == "float32" else steps * recurrent["step"] * 2.0 ** -8)
