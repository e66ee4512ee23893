"""The DreamerV3 host replay buffer in the port's checkpoints, on the CPU.

- The port's ``EnvIndependentReplayBuffer`` state against the JAX
  package's buffer: the same numpy rows (ragged per-env reset rows, past a
  wrap) in both, the JAX buffer converted with ``host_env_buffer_from_jax``
  and loaded into a port buffer: storage, heads and the next 3 draws equal.
- The port's buffer saved (through the checkpoint format, ``weights_only``)
  and loaded equals the original, its next draws included, full and not
  full; a buffer that has not wrapped saves only its filled rows.
- A tiny host-tier ``run`` (the widths of ``tests/test_torch_train_loop.py``)
  writes ``rb`` into its checkpoint, as the JAX loop does with
  ``buffer.checkpoint``; a resume starts with that buffer on the host tier,
  and on the ring the ring's contents and heads equal the host buffer's.
  With ``buffer.checkpoint=false`` no ``rb`` is written.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.convert import host_env_buffer_from_jax
from tests.test_torch_train_loop import TINY_RUN

N_ENVS, SIZE, SEQ = 3, 16, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(rb, steps: int, seed: int = 9):
    """``steps`` all-env rows, and after every fifth a ragged reset row for
    envs 0 and 2; the generators seeded, then one draw taken, so the saved
    generator states are not the seeded ones."""
    rng = np.random.default_rng(seed)
    for t in range(steps):
        rb.add({
            "rgb": rng.integers(0, 256, (1, N_ENVS, 4, 4, 3), dtype=np.uint8),
            "rewards": rng.normal(size=(1, N_ENVS, 1)).astype(np.float32),
            "is_first": np.zeros((1, N_ENVS, 1), np.float32),
        })
        if t % 5 == 2:
            rb.add({"rgb": rng.integers(0, 256, (1, 2, 4, 4, 3), dtype=np.uint8),
                    "rewards": np.ones((1, 2, 1), np.float32), "is_first": np.ones((1, 2, 1), np.float32)}, [0, 2])
    rb.seed(5)
    rb.sample(3, sequence_length=SEQ, n_samples=2)
    return rb


def _assert_same_draws(a, b, draws: int = 3):
    for i in range(draws):
        got = a.sample(4, sequence_length=SEQ, n_samples=1 + i % 2)
        want = b.sample(4, sequence_length=SEQ, n_samples=1 + i % 2)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("steps", [7, 30], ids=["filling", "wrapped"])
def test_torch_rssm_host_buffer_from_jax_draws_what_jax_draws(steps):
    """Both buffers take the same rows; the converted JAX buffer, loaded into
    a port buffer, has JAX's storage and heads and draws JAX's next 3
    samples; the port's own filled buffer holds the same state."""
    ref = _fill(JaxEnvIndependent(SIZE, n_envs=N_ENVS, obs_keys=("rgb",), buffer_cls=JaxSequential), steps)
    port = _fill(EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",)), steps)
    state = host_env_buffer_from_jax(ref)
    own = port.state_dict()
    assert own["rng"] == state["rng"]
    for mine, theirs in zip(own["envs"], state["envs"]):
        assert (mine["pos"], mine["full"], mine["rng"]) == (theirs["pos"], theirs["full"], theirs["rng"])
        for k in theirs["buffer"]:
            assert torch.equal(mine["buffer"][k], theirs["buffer"][k]), k
    assert any(e["full"] for e in state["envs"]) == (steps == 30)
    assert len({e["pos"] for e in state["envs"]}) == 2  # envs 0 and 2 took the reset rows

    loaded = EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",))
    loaded.load_state_dict(state)
    for sub, jsub in zip(loaded.buffer, ref.buffer):
        assert (sub.pos, sub.full) == (jsub._pos, jsub.full)
        rows = SIZE if jsub.full else jsub._pos
        for k, v in jsub.buffer.items():
            np.testing.assert_array_equal(sub.buffer[k][:rows], np.asarray(v)[:rows])
            assert sub.buffer[k].shape == np.asarray(v).shape
    _assert_same_draws(loaded, ref)


@pytest.mark.parametrize("steps", [5, 30], ids=["filling", "wrapped"])
def test_torch_rssm_host_buffer_saved_and_loaded_equals_the_original(steps, tmp_path):
    rb = _fill(EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",)), steps)
    path = save_checkpoint(tmp_path / "rb.ckpt", {"rb": rb.state_dict()})
    state = load_checkpoint(path)["rb"]  # weights_only: tensors, ints and the generator dicts
    for sub, saved in zip(rb.buffer, state["envs"]):
        rows = SIZE if sub.full else sub.pos
        assert all(v.shape[0] == rows for v in saved["buffer"].values())  # only the filled rows until it wraps
    loaded = EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",))
    loaded.load_state_dict(state)
    for sub, orig in zip(loaded.buffer, rb.buffer):
        assert (sub.pos, sub.full) == (orig.pos, orig.full)
        rows = SIZE if orig.full else orig.pos
        for k, v in orig.buffer.items():
            assert sub.buffer[k].shape == v.shape and sub.buffer[k].dtype == v.dtype
            np.testing.assert_array_equal(sub.buffer[k][:rows], v[:rows])
    _assert_same_draws(loaded, rb)


def test_torch_rssm_host_buffer_load_rejects_another_shape():
    rb = _fill(EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",)), 5)
    with pytest.raises(ValueError, match="env buffers"):
        EnvIndependentReplayBuffer(SIZE, N_ENVS + 1, ("rgb",)).load_state_dict(rb.state_dict())
    with pytest.raises(ValueError, match="filled rows"):
        _fill(EnvIndependentReplayBuffer(4, N_ENVS, ("rgb",)), 5).load_state_dict(
            _fill(EnvIndependentReplayBuffer(SIZE, N_ENVS, ("rgb",)), 30).state_dict())


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    return cli.run(TINY_RUN + [f"log_root={root}", "algo.total_steps=12"])


def test_torch_rssm_host_checkpoint_holds_the_buffer(host_run):
    state = load_checkpoint(host_run["checkpoint"])
    rb = state["rb"]
    assert set(rb) == {"envs", "rng"} and len(rb["envs"]) == 1
    (env,) = rb["envs"]
    assert env["pos"] == 12 and not env["full"]  # 64 rows, 12 filled: only those are saved
    assert sorted(env["buffer"]) == ["actions", "is_first", "rewards", "rgb", "terminated", "truncated"]
    assert all(v.shape[:2] == (12, 1) for v in env["buffer"].values())
    assert float(env["buffer"]["is_first"][0, 0, 0]) == 1.0 and env["buffer"]["rgb"].dtype == torch.uint8


def test_torch_rssm_host_checkpoint_resumes_with_its_buffer(host_run, monkeypatch, tmp_path):
    saved = load_checkpoint(host_run["checkpoint"])["rb"]
    seen = []

    class Recording(EnvIndependentReplayBuffer):
        def load_state_dict(self, state):
            super().load_state_dict(state)
            seen.append(self.state_dict())

    monkeypatch.setattr(dv3, "EnvIndependentReplayBuffer", Recording)
    resumed = cli.run([f"checkpoint.resume_from={host_run['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", "algo.learning_starts=1", "algo.total_steps=15", f"log_root={tmp_path}"])
    (restored,) = seen
    assert restored["rng"] == saved["rng"] and restored["envs"][0]["rng"] == saved["envs"][0]["rng"]
    assert restored["envs"][0]["pos"] == 12
    for k, v in saved["envs"][0]["buffer"].items():
        assert torch.equal(restored["envs"][0]["buffer"][k], v), k
    # trained at once from the restored rows, and the next checkpoint holds them and the new ones
    assert not resumed["resident"] and resumed["gradient_steps"] > 0
    after = load_checkpoint(resumed["checkpoint"])["rb"]["envs"][0]
    assert after["pos"] == 15 and torch.equal(after["buffer"]["rgb"][:12], saved["envs"][0]["buffer"]["rgb"])


def test_torch_rssm_host_checkpoint_resumes_on_the_ring(host_run, monkeypatch, tmp_path):
    """``buffer.device_resident=true`` on a host-buffer checkpoint: the ring
    starts as a mirror of the host buffer, its heads the buffer's heads."""
    saved = load_checkpoint(host_run["checkpoint"])["rb"]["envs"][0]
    mirrored = {}

    class Recording(dv3.SequenceRingDriver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            mirrored.update(ring={k: v.clone() for k, v in self.rb_dev.items()}, pos=self.dev_pos.copy(),
                            valid=self.dev_valid.copy())

    monkeypatch.setattr(dv3, "SequenceRingDriver", Recording)
    resumed = cli.run([f"checkpoint.resume_from={host_run['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", "buffer.device_resident=true", "algo.learning_starts=1",
                       "algo.total_steps=15", f"log_root={tmp_path}"])
    assert resumed["resident"] and resumed["gradient_steps"] > 0
    assert mirrored["pos"].tolist() == [12] and mirrored["valid"].tolist() == [12]
    assert sorted(mirrored["ring"]) == ["actions", "is_first", "rewards", "rgb", "terminated"]
    for k, ring in mirrored["ring"].items():
        assert torch.equal(ring[:12], saved["buffer"][k]), k
        assert not ring[12:].any(), k
    assert "kind" in load_checkpoint(resumed["checkpoint"])["rb"]  # the ring's own snapshot from then on


def test_torch_rssm_host_checkpoint_without_buffer_checkpoint_writes_no_buffer(tmp_path):
    summary = cli.run(TINY_RUN + [f"log_root={tmp_path}", "algo.total_steps=9", "buffer.checkpoint=false"])
    assert "rb" not in load_checkpoint(summary["checkpoint"])
