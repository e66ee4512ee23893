"""The ring's episode rule in the port (``sheeprl_tpu_torch/data/ring.py``)
against the JAX package's (``sheeprl_tpu/data/ring.py``), on the CPU.

- ``episode_window_table`` and ``sample_window_starts``: the same ring
  state gives the same ``table`` and ``n_valid``, and the same uniforms the
  same ``(T, B)`` time indices, bit for bit (tolerance 0). Cases: random
  ``is_first`` on a partly filled ring, a full ring wrapped past its head,
  an env with no boundary-free window (its sequential starts), and
  ``seq_len`` equal to the shortest episode.
- ``build_burst_train_step`` with ``episode_rule``: one packed flush and 3
  granted steps of a small regression on the drawn windows, JAX's draws
  (rebuilt from the burst key: ``fold_in`` of the device index,
  ``split(G)``, ``split(k, 3)``) injected into the port. The ring after the
  append equal bit for bit; every drawn window free of interior
  ``is_first`` where its env has a boundary-free window; the losses and the
  parameters within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import ring as jax_ring
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.data import ring

CAP, E = 32, 3


def _state(rng, case):
    """``(pos, valid_n, is_first (C, E, 1), seq_len)`` of one case."""
    seq_len = 4
    pos = rng.integers(0, CAP, E).astype(np.int32)
    valid = np.minimum(pos + rng.integers(0, 2, E) * CAP, CAP).astype(np.int32)
    is_first = (rng.random((CAP, E, 1)) < 0.15).astype(np.float32)
    if case == "wrapped":
        valid[:] = CAP
    elif case == "no_window":
        valid[:] = CAP
        is_first[::2, 1] = 1.0  # env 1: an episode boundary every other row
    elif case == "shortest":
        seq_len = 5
        is_first[:] = 0.0
        for e in range(E):  # episodes of 5, 7 and 9 rows back to back
            is_first[np.arange(e, CAP, 5 + 2 * e), e] = 1.0
    return pos, valid, is_first, seq_len


@pytest.mark.parametrize("case", ["random", "wrapped", "no_window", "shortest"])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_ring_episode_table_and_draw_match_jax(case, seed):
    rng = np.random.default_rng(seed)
    pos, valid, is_first, seq_len = _state(rng, case)
    want_table, want_n = jax_ring.episode_window_table(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(is_first),
                                                        CAP, seq_len)
    table, n_valid = ring.episode_window_table(torch.from_numpy(pos), torch.from_numpy(valid),
                                               torch.from_numpy(is_first), CAP, seq_len)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_table))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(want_n))
    if case == "no_window":  # env 1 falls back to its sequential starts
        assert int(n_valid[1]) == CAP - seq_len + 1

    key = jax.random.PRNGKey(seed)
    env_idx = jax.random.randint(key, (64,), 0, E)
    want = jax_ring.sample_window_starts(key, env_idx, want_table, want_n, CAP, seq_len)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    got = ring.sample_window_starts(u, torch.from_numpy(np.asarray(env_idx)).long(), table, n_valid, CAP, seq_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    once = ring.ring_sample_windows_episode(u, torch.from_numpy(np.asarray(env_idx)).long(), torch.from_numpy(pos),
                                            torch.from_numpy(valid), torch.from_numpy(is_first), CAP, seq_len)
    assert torch.equal(once, got)


# -- the burst step with the episode rule ---------------------------------------

T, B, GRAD_CHUNK, GRANTED, ROWS, LR = 4, 5, 4, 3, 6, 0.05
RING_KEYS = {
    "state": ((3,), np.dtype(np.float32)),
    "actions": ((2,), np.dtype(np.float32)),
    "rewards": ((1,), np.dtype(np.float32)),
    "terminated": ((1,), np.dtype(np.float32)),
    "is_first": ((1,), np.dtype(np.float32)),
}


def _loss_jax(w, batch):
    pred = batch["state"] @ w + batch["actions"].sum(-1, keepdims=True)
    return jnp.mean((pred - batch["rewards"]) ** 2)


def _loss_torch(w, batch):
    pred = batch["state"] @ w + batch["actions"].sum(-1, keepdim=True)
    return torch.mean((pred - batch["rewards"]) ** 2)


@pytest.fixture(scope="module")
def burst():
    rng = np.random.default_rng(4)
    ring_np = {k: rng.normal(size=(CAP, E) + shape).astype(dtype) for k, (shape, dtype) in RING_KEYS.items()}
    ring_np["is_first"] = (rng.random((CAP, E, 1)) < 0.2).astype(np.float32)
    ring_np["is_first"][::2, 2] = 1.0  # env 2 has no boundary-free window
    staged = {k: np.zeros((8, E) + v.shape[2:], v.dtype) for k, v in ring_np.items()}
    for k in staged:
        staged[k][:ROWS] = rng.normal(size=(ROWS, E) + staged[k].shape[2:]).astype(np.float32)
    staged["is_first"][:ROWS] = (rng.random((ROWS, E, 1)) < 0.3).astype(np.float32)
    mask = np.zeros((8, E), np.int32)
    mask[:ROWS] = (rng.random((ROWS, E)) < 0.8).astype(np.int32)
    key = jax.random.PRNGKey(21)
    values = {**staged, "__mask__": mask, "__pos__": np.array([5, 30, 12], np.int32),
              "__valid_n__": np.array([CAP, CAP, 12], np.int32),
              "__validmask__": np.array([1.0] * GRANTED + [0.0] * (GRAD_CHUNK - GRANTED), np.float32)}
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": GRAD_CHUNK, "seq_len": T, "batch_size": B,
            "ring_keys": RING_KEYS, "stage_buckets": (8,), "stage_max": 8, "episode_rule": True}
    w0 = rng.normal(size=(3, 1)).astype(np.float32)

    def jax_step(carry, xs):
        batch, _ = xs
        loss, g = jax.value_and_grad(_loss_jax)(carry, batch)
        return carry - LR * g, (loss,)

    fabric = Fabric(devices=1, accelerator="cpu")
    jax_burst = jax_ring.build_burst_train_step(jax_step, fabric.mesh, spec)
    blob = jax_ring.pack_burst_blob(jax_ring.make_blob_layouts(RING_KEYS, E, GRAD_CHUNK, (8,))[8],
                                    {**values, "__key__": np.asarray(key, np.uint32)})
    jw, jax_rb, (jloss,) = jax_burst(jnp.asarray(w0), {k: jnp.asarray(v) for k, v in ring_np.items()},
                                     jnp.asarray(blob))

    env_idx, u = [], []
    for k in jax.random.split(jax.random.fold_in(key, 0), GRAD_CHUNK)[:GRANTED]:
        k_env, k_start, _ = jax.random.split(k, 3)
        env_idx.append(np.asarray(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.asarray(jax.random.uniform(k_start, (B,))))
    windows, losses = [], []

    def port_step(carry, xs):
        batch, _ = xs
        windows.append(batch["is_first"][..., 0].clone())
        w = carry.clone().requires_grad_(True)
        loss = _loss_torch(w, batch)
        (g,) = torch.autograd.grad(loss, [w])
        losses.append(loss.detach())
        return (w - LR * g).detach(), loss.detach()

    port_burst = ring.build_burst_train_step(port_step, spec, lambda g: None)
    rb = {k: torch.from_numpy(v.copy()) for k, v in ring_np.items()}
    draws = {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)),
             "noise": [None] * GRANTED}
    pw, port_rb, ploss = port_burst(torch.from_numpy(w0), rb,
                                    ring.pack_burst_blob(ring.make_blob_layouts(RING_KEYS, E, GRAD_CHUNK, (8,))[8],
                                                         values), None, draws)
    return {"jax": (np.asarray(jw), {k: np.asarray(v) for k, v in jax_rb.items()}, float(jloss)),
            "port": (pw.numpy(), {k: v.numpy() for k, v in port_rb.items()}, float(ploss)),
            "windows": windows, "env_idx": env_idx}


def test_torch_ring_episode_burst_appends_like_jax(burst):
    for k, want in burst["jax"][1].items():
        np.testing.assert_array_equal(burst["port"][1][k], want, err_msg=k)


def test_torch_ring_episode_burst_windows_hold_no_interior_boundary(burst):
    assert len(burst["windows"]) == GRANTED
    mixed = 0
    for window, envs in zip(burst["windows"], burst["env_idx"]):
        interior = window[1:].sum(0).numpy()  # (B,)
        clean = envs != 2  # env 2 has no boundary-free window: its sequential starts
        assert (interior[clean] == 0).all()
        mixed += int((interior[~clean] > 0).sum())
    assert mixed > 0  # the fallback env's windows do cross boundaries


def test_torch_ring_episode_burst_loss_and_parameters_match_jax(burst):
    np.testing.assert_allclose(burst["port"][2], burst["jax"][2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(burst["port"][0], burst["jax"][0], rtol=0, atol=1e-6)
