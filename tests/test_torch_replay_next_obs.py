"""``buffer.sample_next_obs`` in the port against the JAX package, on the
CPU: the host ``ReplayBuffer`` stores no next observation and reads
``next_<key>`` from row ``(row + 1) % size`` of the same env. For one seed
the port draws the rows and envs the JAX buffer draws (the newest row
excluded until the buffer is full, then the row before the write head), so
every sampled array is equal, exactly, across episode ends; fewer than two
stored rows raise, as in JAX. Then the SAC loop with the flag: it stores no
``next_observations``, trains from the shifted rows (its first sample equal
to the JAX buffer's on the same adds), checkpoints and resumes; on a
uniform device ring it warns and falls back to the host buffer as the JAX
loop does, and a prioritized ring raises.
"""

import importlib

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

sac_module = importlib.import_module("sheeprl_tpu_torch.algos.sac.sac")

SIZE, ENVS = 8, 3
TINY = [
    "fabric.accelerator=cpu", "metric.log_level=0", "algo.run_test=false", "env.num_envs=2", "buffer.size=64",
    "algo.hidden_size=32", "algo.actor.hidden_size=32", "algo.critic.hidden_size=32", "algo.per_rank_batch_size=8",
    "algo.learning_starts=16", "checkpoint.every=0", "checkpoint.save_last=true", "buffer.sample_next_obs=true",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(start: int, n: int):
    """``n`` rows of ``ENVS`` transitions whose values name their row, env
    and key, with an episode end every 5 rows."""
    t = np.arange(start, start + n, dtype=np.float32)[:, None]
    env = np.arange(ENVS, dtype=np.float32)[None, :]
    return {
        "observations": np.stack([t * 10 + env, -(t * 10 + env)], axis=-1).astype(np.float32),
        "actions": (t + env / 10).astype(np.float32)[..., None],
        "rewards": (t * 100 + env).astype(np.float32)[..., None],
        "terminated": ((t % 5 == 4) & (env >= 0)).astype(np.uint8)[..., None],
    }


def _pair(filled: int):
    port, jax_rb = ReplayBuffer(SIZE, ENVS), JaxReplayBuffer(SIZE, ENVS)
    port.seed(7)
    jax_rb.seed(7)
    done = 0
    while done < filled:  # adds of 1 to 3 rows, wrapping the ring
        n = min(1 + done % 3, filled - done)
        data = _rows(done, n)
        port.add(data)
        jax_rb.add(data)
        done += n
    return port, jax_rb


@pytest.mark.parametrize("filled", [2, 3, 7, 8, 9, 12, 16, 17], ids=lambda n: f"rows{n}")
@pytest.mark.parametrize("n_samples", [1, 3])
def test_torch_replay_next_obs_sample_equals_jax(filled, n_samples):
    port, jax_rb = _pair(filled)
    assert port.full == jax_rb.full and port.pos == jax_rb._pos
    for _ in range(3):  # successive draws stay in step
        got = port.sample(5, n_samples, sample_next_obs=True)
        want = jax_rb.sample(5, sample_next_obs=True, n_samples=n_samples)
        assert set(got) == set(want) == {"observations", "next_observations", "actions", "rewards", "terminated"}
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("filled", [3, 8, 9, 12])
def test_torch_replay_next_obs_pairs_are_the_next_row_of_the_same_env(filled):
    """Every pair reads the next row of its own env, and the newest row
    (the one before the write head) is never drawn."""
    port, _ = _pair(filled)
    out = port.sample(64, 1, sample_next_obs=True)
    obs, nxt = out["observations"][0, :, 0], out["next_observations"][0, :, 0]
    row, env = np.floor(obs / 10) % SIZE, obs % 10
    np.testing.assert_array_equal(nxt % 10, env)
    newest = (port.pos - 1) % SIZE
    assert not np.any(row == newest)
    np.testing.assert_array_equal(np.floor(nxt / 10) % SIZE, (row + 1) % SIZE)


def test_torch_replay_next_obs_needs_two_rows_as_jax():
    port, jax_rb = _pair(1)
    with pytest.raises(RuntimeError, match="two stored transitions"):
        port.sample(4, 1, sample_next_obs=True)
    with pytest.raises(RuntimeError, match="two stored transitions"):
        jax_rb.sample(4, sample_next_obs=True)
    # without the flag one row is enough on both
    np.testing.assert_array_equal(port.sample(4, 1)["rewards"], np.asarray(jax_rb.sample(4)["rewards"]))


def test_torch_replay_next_obs_without_the_flag_is_unchanged():
    port, jax_rb = _pair(12)
    got, want = port.sample(6, 2), jax_rb.sample(6, n_samples=2)
    assert set(got) == set(want) and "next_observations" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _run(tmp_path, *extra):
    return cli.run(["preset=sac", f"log_root={tmp_path}"] + TINY + list(extra))


def test_torch_replay_next_obs_sac_loop_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    samples = []
    real = ReplayBuffer.sample

    def spy(self, batch_size, n_samples=1, sample_next_obs=False):
        out = real(self, batch_size, n_samples, sample_next_obs=sample_next_obs)
        samples.append((sample_next_obs, out))
        return out

    monkeypatch.setattr(ReplayBuffer, "sample", spy)
    s = _run(tmp_path, "algo.total_steps=64")
    assert not s["resident"] and s["gradient_steps"] > 0 and np.isfinite(np.asarray(s["losses"])).all()
    assert samples and all(flag for flag, _ in samples)
    assert "next_observations" in samples[0][1]
    saved = load_checkpoint(s["checkpoint"])
    assert "next_observations" not in saved["rb"]["buffer"] and "observations" in saved["rb"]["buffer"]
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=80", "algo.learning_starts=4",
                       f"log_root={tmp_path}", "fabric.accelerator=cpu", "metric.log_level=0"])
    assert resumed["start_iter"] == 33 and resumed["gradient_steps"] > 0


def test_torch_replay_next_obs_sac_first_sample_equals_the_jax_buffer(tmp_path, monkeypatch):
    """The loop's stored rows, replayed into the JAX buffer with the loop's
    seed, give the loop's first training sample."""
    adds, samples = [], []
    real_add, real_sample = ReplayBuffer.add, ReplayBuffer.sample

    def add_spy(self, data, **kwargs):
        adds.append({k: np.array(v) for k, v in data.items()})
        return real_add(self, data, **kwargs)

    def sample_spy(self, batch_size, n_samples=1, sample_next_obs=False):
        out = real_sample(self, batch_size, n_samples, sample_next_obs=sample_next_obs)
        if not samples:
            samples.append((len(adds), batch_size, n_samples, out))
        return out

    monkeypatch.setattr(ReplayBuffer, "add", add_spy)
    monkeypatch.setattr(ReplayBuffer, "sample", sample_spy)
    _run(tmp_path, "algo.total_steps=40", "checkpoint.save_last=false")
    n_adds, batch, n, got = samples[0]
    jax_rb = JaxReplayBuffer(32, 2)
    jax_rb.seed(42)
    for data in adds[:n_adds]:
        assert "next_observations" not in data
        jax_rb.add(data)
    want = jax_rb.sample(batch, sample_next_obs=True, n_samples=n)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_torch_replay_next_obs_uniform_ring_falls_back_to_the_host_buffer(tmp_path):
    with pytest.warns(UserWarning, match="falling back to the host buffer"):
        s = _run(tmp_path, "algo.total_steps=40", "buffer.device_resident=true")
    assert not s["resident"] and s["gradient_steps"] > 0


def test_torch_replay_next_obs_prioritized_ring_raises(tmp_path):
    with pytest.raises(ValueError, match="sample_next_obs"):
        cli.run(["preset=sac_per", f"log_root={tmp_path}"] + TINY + ["algo.total_steps=40"])
