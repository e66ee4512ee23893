"""The recurrent PPO update of the port (``sheeprl_tpu_torch/algos/ppo_recurrent``)
against the JAX package's, on the CPU.

**Chunking and bucketing.** JAX's shape bucketing changes the math: which
sequences share a minibatch depends on how the rollout is cut into
sequences and how their count is padded (``_bucket``: ``S_pad = quantum *
2**k``, the per-epoch permutation over ``S_pad``, ``mb = S_pad //
per_rank_num_batches``, each minibatch's losses a mean over its own mask).
So ``chunk_sequences`` must give JAX's arrays exactly, on a rollout with
dones in the middle of sequences, at the start and at the end, and
``bucket`` JAX's ``_bucket`` for every count.

**One update.** 4 envs x 32 steps cut into sequences of 8, padded to
``S_pad``, 2 epochs x 2 minibatches, Adam at the recipe's lr 3e-4, clip
0.5, both sides from the same flax weights (``ppo_recurrent_state_from_jax``)
and JAX's own per-epoch permutations (``fold_in`` of the device index,
``split`` per epoch, ``permutation`` over ``S_pad``). Cases: the recipe's
losses, and normalised advantages with the clipped value loss.

- The whole update: the three mean losses within rtol 1e-5, every
  parameter within rtol 1e-5 (atol 1e-6: an element near 0).
- Every minibatch step: JAX's update run one minibatch at a time (1 epoch,
  1 batch, over that minibatch's sequences), the port's step taken from
  JAX's parameters and Adam state just before it; the step's losses within
  rtol 1e-5, the parameters after it within rtol 1e-5 (atol 1e-6).

float32 on both sides; torch's LSTM and XLA's scan sum the gate products
in another order, so no bit-equality is asked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent.agent import RecurrentPPOAgent as JaxAgent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import _bucket as jax_bucket
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.ppo_recurrent.utils import chunk_sequences as jax_chunk_sequences
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import bucket, chunk_sequences, pad_sequences
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_recurrent_state_from_jax

N_ENVS, T, SEQ, NB, EPOCHS, H = 4, 32, 8, 2, 2, 64
RTOL, ATOL = 1e-5, 1e-6
CASES = {
    "recipe": [],
    "normalized-clipped": ["algo.normalize_advantages=True", "algo.clip_vloss=True"],
}


def rollout(seed, t=T, n=N_ENVS, seq=SEQ):
    """A ``(t, n, ...)`` rollout with episodes ending mid-sequence, on the
    first step, on the last and twice in a row."""
    rng = np.random.default_rng(seed)
    dones = (rng.uniform(size=(t, n, 1)) < 0.12).astype(np.float32)
    dones[0, 0] = dones[t - 1, 1] = dones[seq // 2, 2] = dones[seq // 2 + 1, 2] = 1.0
    return {
        "state": rng.normal(size=(t, n, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (t, n))],
        "prev_actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (t, n))],
        "logprobs": (np.log(0.5) + 0.2 * rng.normal(size=(t, n, 1))).astype(np.float32),
        "values": rng.normal(size=(t, n, 1)).astype(np.float32),
        "returns": (rng.normal(size=(t, n, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(t, n, 1)).astype(np.float32),
        "rewards": np.ones((t, n, 1), np.float32),
        "dones": dones,
        "prev_hx": (rng.normal(size=(t, n, H)) * 0.3).astype(np.float32),
        "prev_cx": (rng.normal(size=(t, n, H)) * 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("seq", [1, 5, 8, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_ppo_recurrent_update_chunk_sequences_is_jax_s(seed, seq):
    data = rollout(seed, seq=min(seq, 8))
    got, got_mask = chunk_sequences(data, T, N_ENVS, seq)
    want, want_mask = jax_chunk_sequences(data, T, N_ENVS, seq)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.dtype == want_mask.dtype and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    if seq == 1:
        assert got_mask.shape[1] == N_ENVS * T and got_mask.all()
    else:  # the dones cut more sequences than the envs alone would
        assert got_mask.shape[1] > N_ENVS * -(-T // seq)


def test_torch_ppo_recurrent_update_bucket_is_jax_s():
    for quantum in (1, 2, 8, 16, 24):
        for n in range(0, 700, 7):
            assert bucket(n, quantum) == jax_bucket(n, quantum), (n, quantum)
    padded, mask = chunk_sequences(rollout(0), T, N_ENVS, SEQ)
    out = pad_sequences(padded, mask, 8)
    s_pad = jax_bucket(mask.shape[1], 8)
    assert out["mask"].shape == (SEQ, s_pad) and out["prev_hx"].shape == (1, s_pad, H)
    assert out["mask"][:, mask.shape[1]:].sum() == 0 and out["state"][:, mask.shape[1]:].sum() == 0
    np.testing.assert_array_equal(out["prev_cx"][0, : mask.shape[1]], padded["prev_cx"][0])


def _cfgs(case, epochs=EPOCHS, nb=NB):
    over = [f"env.num_envs={N_ENVS}", f"algo.rollout_steps={T}", f"algo.per_rank_sequence_length={SEQ}",
            f"algo.per_rank_num_batches={nb}", f"algo.update_epochs={epochs}"] + CASES[case]
    return compose(["exp=ppo_recurrent"] + over), apply_overrides(preset("ppo_recurrent"), over)


def _adam(tree):
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(tree)
    return found[0]


def _tx(cfg):
    return optax.inject_hyperparams(lambda learning_rate: jax_build_optimizer(
        {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm))(
        learning_rate=float(cfg.algo.optimizer.lr))


def jax_epoch_permutations(key, epochs, s_local):
    """``local_train``'s per-epoch permutations on device 0 of the mesh."""
    key = jax.random.fold_in(key, 0)
    return np.stack([np.asarray(jax.random.permutation(k, s_local)) for k in jax.random.split(key, epochs)])


def _port_from_jax(port_cfg, params, opt_state=None):
    """The port's agent and Adam on JAX's parameters and Adam state."""
    agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu",
                           ppo_recurrent_state_from_jax(jax.tree.map(np.asarray, params)))
    optimizer = make_optimizer(port_cfg, agent)
    if opt_state is not None:
        adam = _adam(opt_state)
        mu = ppo_recurrent_state_from_jax(jax.tree.map(np.asarray, adam.mu))
        nu = ppo_recurrent_state_from_jax(jax.tree.map(np.asarray, adam.nu))
        names = {p: n for n, p in agent.named_parameters()}
        for p, st in optimizer.optimizer.state.items():
            st["exp_avg"].copy_(mu[names[p]])
            st["exp_avg_sq"].copy_(nu[names[p]])
            st["step"] = torch.tensor(float(np.asarray(adam.count)))
    return agent, optimizer


def _close(got, want, what):
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    case = request.param
    cfg, port_cfg = _cfgs(case)
    jax_agent = JaxAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                         encoder_cfg=dict(cfg.algo.encoder), rnn_cfg=dict(cfg.algo.rnn),
                         actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic))
    z = jnp.zeros((1, H))
    params = jax_agent.init(jax.random.PRNGKey(3), {"state": jnp.zeros((1, 1, 4))}, jnp.zeros((1, 1, 2)), z, z)
    padded, mask = chunk_sequences(rollout(5), T, N_ENVS, SEQ)
    data = pad_sequences(padded, mask, NB)
    return case, cfg, port_cfg, jax_agent, params, data


def test_torch_ppo_recurrent_update_whole_update_matches_jax(setup):
    case, cfg, port_cfg, jax_agent, params, data = setup
    s_pad = data["mask"].shape[1]
    tx = _tx(cfg)
    train = jax_make_train_step(jax_agent, tx, cfg, Fabric(devices=1, accelerator="cpu").mesh, s_pad)
    key = jax.random.PRNGKey(9)
    start = jax.tree.map(np.asarray, params)
    new_params, _, pg, v, ent = train(jax.tree.map(jnp.array, start), tx.init(params), data, key,
                                      jnp.float32(0.2), jnp.float32(0.001))
    agent, optimizer = _port_from_jax(port_cfg, start)
    losses = make_train_step(agent, optimizer, port_cfg, s_pad)(
        {k: torch.from_numpy(np.array(v_)) for k, v_ in data.items()}, 0.2, 0.001,
        perms=torch.from_numpy(jax_epoch_permutations(key, EPOCHS, s_pad)))
    np.testing.assert_allclose(losses.numpy(), [float(pg), float(v), float(ent)], rtol=RTOL, atol=1e-7)
    got = {n: p.detach() for n, p in agent.named_parameters()}
    _close(got, ppo_recurrent_state_from_jax(jax.tree.map(np.asarray, new_params)), "params")
    assert {int(s["step"]) for s in optimizer.optimizer.state.values()} == {EPOCHS * NB}


def test_torch_ppo_recurrent_update_every_minibatch_step_matches_jax(setup):
    case, cfg, port_cfg, jax_agent, params, data = setup
    s_pad = data["mask"].shape[1]
    mb = s_pad // NB
    one_cfg, one_port_cfg = _cfgs(case, epochs=1, nb=1)
    tx = _tx(one_cfg)
    step = jax_make_train_step(jax_agent, tx, one_cfg, Fabric(devices=1, accelerator="cpu").mesh, mb)
    perms = jax_epoch_permutations(jax.random.PRNGKey(9), EPOCHS, s_pad)
    params = jax.tree.map(np.asarray, params)
    opt_state = tx.init(params)
    checked = 0
    for e in range(EPOCHS):
        for m in range(NB):
            rows = perms[e, m * mb:(m + 1) * mb]
            batch = {k: np.ascontiguousarray(v[:, rows]) for k, v in data.items()}
            key = jax.random.PRNGKey(100 + checked)
            agent, optimizer = _port_from_jax(one_port_cfg, params, opt_state)
            losses = make_train_step(agent, optimizer, one_port_cfg, mb)(
                {k: torch.from_numpy(v) for k, v in batch.items()}, 0.2, 0.001,
                perms=torch.from_numpy(jax_epoch_permutations(key, 1, mb)))
            new_params, opt_state, pg, v, ent = step(jax.tree.map(jnp.array, params), opt_state, batch, key,
                                                     jnp.float32(0.2), jnp.float32(0.001))
            params = jax.tree.map(np.asarray, new_params)
            np.testing.assert_allclose(losses.numpy(), [float(pg), float(v), float(ent)], rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {checked}: {LOSS_NAMES}")
            _close({n: p.detach() for n, p in agent.named_parameters()}, ppo_recurrent_state_from_jax(params),
                   f"step {checked}")
            checked += 1
    assert checked == EPOCHS * NB
