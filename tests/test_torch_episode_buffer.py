"""The port's ``EpisodeBuffer`` against the JAX package's, on the CPU, from
the same numpy rows and the same seed: the stored episodes and their
cumulative lengths after ragged multi-env adds (episodes ending mid-chunk,
several in one chunk, open ones left across adds), the eviction of the
oldest episodes by cumulative length, and the windows ``sample`` draws
(``(n_samples, T, B, ...)``) equal key by key, with and without
``prioritize_ends`` and ``sample_next_obs``; then the memmapped layout,
``state_dict``/``load_state_dict`` and ``episode_buffer_from_jax`` (a
restored buffer draws what the saved one would), and the JAX buffer's
errors."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu_torch.data import EpisodeBuffer
from sheeprl_tpu_torch.utils.convert import episode_buffer_from_jax

N_ENVS, OBS_KEYS = 3, ("rgb", "state")


def _chunks(seed: int, n_chunks: int = 12, rows: int = 9, p_end: float = 0.08):
    """``n_chunks`` adds of ``rows`` steps for every env (and, every third
    add, a 1-row add for a subset of envs, as a loop's reset rows are)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n_chunks):
        n = rows
        ends = rng.random((n, N_ENVS, 1)) < p_end
        data = {
            "rgb": rng.integers(0, 255, (n, N_ENVS, 4, 4, 3)).astype(np.uint8),
            "state": rng.normal(size=(n, N_ENVS, 5)).astype(np.float32),
            "actions": rng.normal(size=(n, N_ENVS, 2)).astype(np.float32),
            "rewards": rng.normal(size=(n, N_ENVS, 1)).astype(np.float32),
            "terminated": (ends & (rng.random((n, N_ENVS, 1)) < 0.5)).astype(np.float32),
            "truncated": np.zeros((n, N_ENVS, 1), np.float32),
            "is_first": np.zeros((n, N_ENVS, 1), np.float32),
        }
        data["truncated"] = (ends & (data["terminated"] == 0)).astype(np.float32)
        out.append((data, None))
        if c % 3 == 2:
            idx = [0, 2]
            out.append(({k: v[-1:, idx].copy() for k, v in data.items()}, idx))
    return out


def _fill(buffers, chunks):
    for data, idx in chunks:
        for b in buffers:
            b.add({k: v.copy() for k, v in data.items()}, idx)


def _pair(size=200, min_len=3, prioritize_ends=False, seed=0, **port_kw):
    jax_rb = JaxEpisodeBuffer(size, min_len, n_envs=N_ENVS, obs_keys=OBS_KEYS, prioritize_ends=prioritize_ends)
    port_rb = EpisodeBuffer(size, min_len, n_envs=N_ENVS, obs_keys=OBS_KEYS, prioritize_ends=prioritize_ends, **port_kw)
    jax_rb.seed(seed)
    port_rb.seed(seed)
    return jax_rb, port_rb


def _same_store(jax_rb, port_rb):
    assert len(port_rb) == len(jax_rb)
    assert port_rb._cum_lengths == list(jax_rb._cum_lengths)
    assert len(port_rb.buffer) == len(jax_rb.buffer)
    for a, b in zip(port_rb.buffer, jax_rb.buffer):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _same_samples(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_episode_buffer_stores_what_jax_stores(seed):
    jax_rb, port_rb = _pair(size=10_000, min_len=1)
    _fill([jax_rb, port_rb], _chunks(seed))
    assert len(jax_rb.buffer) > 3
    _same_store(jax_rb, port_rb)
    for env in range(N_ENVS):  # the episodes still open
        assert len(port_rb._open_episodes[env]) == len(jax_rb._open_episodes[env])


@pytest.mark.parametrize("size", [40, 60, 97])
def test_torch_episode_buffer_evicts_as_jax_does(size):
    jax_rb, port_rb = _pair(size=size, min_len=1)
    chunks = _chunks(3, n_chunks=20, p_end=0.15)
    for data, idx in chunks:
        _fill([jax_rb, port_rb], [(data, idx)])
        _same_store(jax_rb, port_rb)
        assert port_rb.full == jax_rb.full
    assert len(port_rb) <= size


@pytest.mark.parametrize("prioritize_ends", [False, True], ids=["uniform", "ends"])
@pytest.mark.parametrize("sample_next_obs", [False, True], ids=["obs", "next_obs"])
@pytest.mark.parametrize("seq_len", [1, 4])
def test_torch_episode_buffer_draws_jax_windows(prioritize_ends, sample_next_obs, seq_len):
    jax_rb, port_rb = _pair(size=10_000, min_len=1, prioritize_ends=prioritize_ends, seed=11)
    _fill([jax_rb, port_rb], _chunks(4, n_chunks=15, p_end=0.1))
    for n_samples, batch in ((1, 5), (3, 7)):
        want = jax_rb.sample(batch, sample_next_obs=sample_next_obs, n_samples=n_samples, sequence_length=seq_len)
        got = port_rb.sample(batch, sample_next_obs=sample_next_obs, n_samples=n_samples, sequence_length=seq_len)
        _same_samples(got, want)
        assert got["rgb"].shape[:3] == (n_samples, seq_len, batch)


def test_torch_episode_buffer_prioritize_ends_reaches_the_last_window():
    """Starts past ``ep_len - T`` are clipped to it: the windows that end
    an episode come more often than uniform start draws give them."""
    rb = EpisodeBuffer(1000, 1, n_envs=1, obs_keys=("obs",), prioritize_ends=True)
    rb.seed(0)
    n = 20
    done = np.zeros((n, 1, 1), np.float32)
    done[-1] = 1
    rb.add({"obs": np.arange(n, dtype=np.float32).reshape(n, 1, 1), "terminated": done,
            "truncated": np.zeros_like(done)})
    starts = rb.sample(1, n_samples=2000, sequence_length=5)["obs"][:, 0, 0, 0]
    assert starts.max() == n - 5
    assert np.mean(starts == n - 5) > 0.2  # 6 of the 21 start slots clip to the last: ~0.29, uniform ~0.06


def test_torch_episode_buffer_memmap_layout_and_round_trip(tmp_path):
    jax_rb, port_rb = _pair(size=80, min_len=1, memmap=True, memmap_dir=tmp_path / "mm")
    _fill([jax_rb, port_rb], _chunks(5, n_chunks=14, p_end=0.12))
    _same_store(jax_rb, port_rb)
    dirs = sorted(p.name for p in (tmp_path / "mm").iterdir())
    assert len(dirs) == len(port_rb.buffer) and all(d.startswith("episode_") for d in dirs)  # evicted ones are gone
    assert sorted(p.name for p in (tmp_path / "mm" / dirs[0]).iterdir()) == sorted(
        f"{k}.memmap" for k in ("rgb", "state", "actions", "rewards", "terminated", "truncated", "is_first"))
    state = port_rb.state_dict()
    restored = EpisodeBuffer(80, 1, n_envs=N_ENVS, obs_keys=OBS_KEYS, memmap=True, memmap_dir=tmp_path / "mm2")
    restored.load_state_dict(state)
    _same_store(jax_rb, restored)
    _same_samples(restored.sample(6, n_samples=2, sequence_length=2), jax_rb.sample(6, n_samples=2, sequence_length=2))
    # the open episodes carry over: the next adds store what the JAX buffer stores
    more = _chunks(6, n_chunks=4, p_end=0.2)
    _fill([jax_rb, restored], more)
    _same_store(jax_rb, restored)


def test_torch_episode_buffer_converts_a_jax_buffer():
    jax_rb, _ = _pair(size=150, min_len=1, prioritize_ends=True, seed=9)
    _fill([jax_rb], _chunks(7, n_chunks=12))
    port_rb = EpisodeBuffer(150, 1, n_envs=N_ENVS, obs_keys=OBS_KEYS, prioritize_ends=True)
    port_rb.load_state_dict(episode_buffer_from_jax(jax_rb))
    _same_store(jax_rb, port_rb)
    _same_samples(port_rb.sample(8, n_samples=2, sequence_length=3), jax_rb.sample(8, n_samples=2, sequence_length=3))
    saved = port_rb.state_dict()
    assert all(isinstance(v, torch.Tensor) for ep in saved["episodes"] for v in ep.values())


def test_torch_episode_buffer_raises_as_jax_does():
    with pytest.raises(ValueError):
        EpisodeBuffer(4, 8)
    rb = EpisodeBuffer(50, 5, n_envs=1, obs_keys=("obs",))
    done = np.ones((1, 1, 1), np.float32)
    with pytest.raises(RuntimeError, match="shorter"):
        rb.add({"obs": np.zeros((1, 1, 1), np.float32), "terminated": done, "truncated": np.zeros_like(done)})
    with pytest.raises(RuntimeError, match="nothing to sample"):
        rb.sample(2, sequence_length=3)
    with pytest.raises(RuntimeError, match="terminated"):
        rb.add({"obs": np.zeros((1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="open episodes"):
        EpisodeBuffer(50, 5, n_envs=2).load_state_dict(rb.state_dict())
