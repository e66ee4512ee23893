"""``sheeprl_tpu_torch/replay/indices.py`` against the JAX package's
``sheeprl_tpu/replay/indices.py`` and against the port's host buffers, on
the CPU.

Both index modules and the buffer are driven from one seeded numpy
generator: the buffer through its own ``sample``, the index modules by the
same ``rng.integers`` calls pushed through their eligible-row arithmetic.
The index streams are equal bit for bit (tolerance 0), as are the values
they gather, across a partial buffer, an exactly full one and a wrapped
one, with and without next-observation pairs, and at a write head back at
0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.replay import indices as jax_indices
from sheeprl_tpu_torch.data.buffers import ReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.replay import indices

CAP, N_ENVS = 8, 3


def _filled(cls, n_rows: int, n_envs: int = N_ENVS):
    """A buffer whose values encode (step, env)."""
    rb = cls(CAP, n_envs, obs_keys=("observations",))
    for t in range(n_rows):
        rb.add({"observations": np.full((1, n_envs, 1), t * 100, np.float32) + np.arange(n_envs).reshape(1, -1, 1)})
    return rb


def _both(fn_name, *args, **kw):
    """The port's function on tensors and JAX's on arrays, as numpy; equal."""
    port = getattr(indices, fn_name)(*[torch.as_tensor(a) for a in args], **kw)
    want = getattr(jax_indices, fn_name)(*[jnp.asarray(a) for a in args], **kw)
    np.testing.assert_array_equal(port.numpy(), np.asarray(want), err_msg=fn_name)
    return port.numpy()


@pytest.mark.parametrize("n_rows", [5, CAP, CAP + 3, 2 * CAP], ids=["partial", "full", "wrapped", "head_at_0"])
@pytest.mark.parametrize("sample_next_obs", [False, True], ids=["obs", "next_obs"])
def test_torch_replay_indices_uniform_stream_matches_jax_and_buffer(n_rows, sample_next_obs):
    seed, batch = 1234, 64
    rb = _filled(ReplayBuffer, n_rows)
    rb.seed(seed)
    host = rb.sample(batch_size=batch, sample_next_obs=sample_next_obs)

    rng = np.random.default_rng(seed)
    pos, full = np.int64(rb.pos), np.int64(rb.full)
    n = int(_both("uniform_eligible", pos, full, CAP, sample_next_obs=sample_next_obs))
    draws = rng.integers(0, n, size=(batch,), dtype=np.intp)
    rows = _both("map_uniform_draw", draws.astype(np.int64), pos, full, CAP, sample_next_obs=sample_next_obs)
    env = rng.integers(0, N_ENVS, size=(batch,), dtype=np.intp)
    storage = np.asarray(rb.buffer["observations"])
    np.testing.assert_array_equal(host["observations"].reshape(batch, 1), storage[rows, env])
    if sample_next_obs:
        nxt = _both("next_rows", rows, CAP)
        np.testing.assert_array_equal(host["next_observations"].reshape(batch, 1), storage[nxt, env])


@pytest.mark.parametrize("n_rows", [6, CAP, CAP + 5], ids=["partial", "full", "wrapped"])
@pytest.mark.parametrize("n_envs", [1, N_ENVS])
def test_torch_replay_indices_sequence_stream_matches_jax_and_buffer(n_rows, n_envs):
    seed, batch, seq_len = 99, 32, 3
    rb = _filled(SequentialReplayBuffer, n_rows, n_envs)
    rb.seed(seed)
    host = rb.sample(batch_size=batch, sequence_length=seq_len)  # (1, T, B, 1)

    rng = np.random.default_rng(seed)
    pos, full = np.int64(rb.pos), np.int64(rb.full)
    n = int(_both("sequence_eligible", pos, full, CAP, seq_len=seq_len))
    draws = rng.integers(0, n, size=(batch,), dtype=np.intp).astype(np.int64)
    starts = _both("map_sequence_draw", draws, pos, full, CAP, seq_len=seq_len)
    env = np.zeros(batch, np.intp) if n_envs == 1 else rng.integers(0, n_envs, size=(batch,), dtype=np.intp)
    rows = _both("window_rows", starts, seq_len, CAP)
    np.testing.assert_array_equal(host["observations"][0], np.asarray(rb.buffer["observations"])[rows, env[None, :]])


def test_torch_replay_indices_windows_never_cross_the_write_head():
    seq_len = 3
    rb = _filled(SequentialReplayBuffer, CAP + 5, 1)
    pos = np.int64(rb.pos)
    n = int(_both("sequence_eligible", pos, np.int64(1), CAP, seq_len=seq_len))
    starts = _both("map_sequence_draw", np.arange(n, dtype=np.int64), pos, np.int64(1), CAP, seq_len=seq_len)
    rows = _both("window_rows", starts, seq_len, CAP)
    for w in rows.T.tolist():
        assert all(not (a == (pos - 1) % CAP and c == pos % CAP) for a, c in zip(w[:-1], w[1:]))


def test_torch_replay_indices_prioritized_end_starts_matches_jax():
    seq_len, n_starts = 4, 10
    draws = np.random.default_rng(3).integers(0, n_starts + seq_len, size=(512,))
    got = _both("prioritized_end_starts", draws, np.int64(n_starts), seq_len=seq_len)
    np.testing.assert_array_equal(got, np.minimum(draws, n_starts - 1))
