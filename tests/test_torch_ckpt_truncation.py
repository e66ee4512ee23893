"""The checkpoint's truncation patch of the host buffers against the JAX
package's ``CheckpointCallback._ckpt_rb`` (``sheeprl_tpu/utils/callback.py``),
on the CPU.

JAX patches the live buffer for the save and reverts it after: a
``ReplayBuffer``'s newest row gets ``truncated = 1`` in every env, an
``EnvIndependentReplayBuffer``'s newest row of each env, and an
``EpisodeBuffer`` is saved without its open episodes. The port's
``checkpoint_state_dict`` gives the same saved state (exactly) from a copy,
and the live buffer, memmapped or not, stays as it was, also through the
checkpoint manager's asynchronous save. A run of each kind saves the
patched state: SAC's host tier and DreamerV3's host tier.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.utils.callback import CheckpointCallback
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer
from sheeprl_tpu_torch.fault import CheckpointManager
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import episode_buffer_from_jax, host_env_buffer_from_jax

SIZE, N_ENVS = 8, 3


def _rows(rng, n_envs, truncated_dtype):
    return {
        "observations": rng.normal(size=(1, n_envs, 2)).astype(np.float32),
        "terminated": np.zeros((1, n_envs, 1), np.float32),
        "truncated": np.zeros((1, n_envs, 1), truncated_dtype),
    }


def _states_equal(got, want):
    """Equal saved states, the generators' states aside (the buffers here
    are not seeded alike)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k != "rng":
                _states_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _states_equal(g, w)
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("memmap", [False, True], ids=["ram", "memmap"])
@pytest.mark.parametrize("steps", [5, 13], ids=["filling", "wrapped"])
def test_torch_ckpt_truncation_replay_buffer_matches_jax(tmp_path, steps, memmap):
    rng = np.random.default_rng(steps)
    jax_rb = JaxReplayBuffer(SIZE, N_ENVS)
    port = ReplayBuffer(SIZE, N_ENVS, memmap=memmap, memmap_dir=tmp_path / "rb")
    for _ in range(steps):
        row = _rows(rng, N_ENVS, np.uint8)
        jax_rb.add(row)
        port.add(row)
    live = {k: torch.from_numpy(np.array(v)).clone() for k, v in port.state_dict()["buffer"].items()}
    cb = CheckpointCallback()
    saved = cb._ckpt_rb(jax_rb)
    filled = SIZE if steps >= SIZE else steps
    want = {k: np.array(np.asarray(jax_rb[k])[:filled]) for k in ("observations", "terminated", "truncated")}
    cb._experiment_consistent_rb(jax_rb, saved)
    got = port.checkpoint_state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got["buffer"][k].numpy(), v, err_msg=k)
    assert int(got["buffer"]["truncated"].sum()) == N_ENVS
    for k, v in port.state_dict()["buffer"].items():  # the live buffer is untouched
        assert torch.equal(v, live[k]), k
    assert int(np.asarray(jax_rb["truncated"])[:filled].sum()) == 0  # JAX reverted its patch


@pytest.mark.parametrize("memmap", [False, True], ids=["ram", "memmap"])
def test_torch_ckpt_truncation_env_independent_matches_jax(tmp_path, memmap):
    rng = np.random.default_rng(3)
    jax_rb = JaxEnvIndependent(SIZE, n_envs=N_ENVS, obs_keys=("observations",), buffer_cls=JaxSequential)
    port = EnvIndependentReplayBuffer(SIZE, N_ENVS, ("observations",), memmap=memmap, memmap_dir=tmp_path / "rb")
    for t in range(11):
        row = _rows(rng, N_ENVS, np.float32)
        jax_rb.add(row)
        port.add(row)
        if t % 4 == 1:  # ragged reset rows: the envs' heads part
            reset = {k: v[:, [0, 2]] for k, v in _rows(rng, N_ENVS, np.float32).items()}
            jax_rb.add(reset, [0, 2])
            port.add(reset, [0, 2])
    live = port.state_dict()
    live = {"envs": [{k: v.clone() for k, v in e["buffer"].items()} for e in live["envs"]]}
    cb = CheckpointCallback()
    saved = cb._ckpt_rb(jax_rb)
    want = host_env_buffer_from_jax(jax_rb)
    cb._experiment_consistent_rb(jax_rb, saved)
    got = port.checkpoint_state_dict()
    _states_equal(got, want)
    assert [int(e["buffer"]["truncated"].sum()) for e in got["envs"]] == [1] * N_ENVS
    assert [e["pos"] for e in got["envs"]] != [got["envs"][0]["pos"]] * N_ENVS  # heads at different rows
    for e, before in zip(port.state_dict()["envs"], live["envs"]):
        for k, v in e["buffer"].items():
            assert torch.equal(v, before[k]), k


def test_torch_ckpt_truncation_episode_buffer_matches_jax():
    rng = np.random.default_rng(4)
    jax_rb = JaxEpisodeBuffer(64, 2, n_envs=2, obs_keys=("observations",))
    port = EpisodeBuffer(64, 2, n_envs=2, obs_keys=("observations",))
    for t in range(9):
        row = _rows(rng, 2, np.float32)
        row["terminated"][0, 0, 0] = float(t == 4)  # env 0 ends an episode; both keep an open one
        jax_rb.add(row)
        port.add(row)
    cb = CheckpointCallback()
    saved = cb._ckpt_rb(jax_rb)
    want = episode_buffer_from_jax(jax_rb)
    cb._experiment_consistent_rb(jax_rb, saved)
    got = port.checkpoint_state_dict()
    _states_equal(got, want)
    assert got["open"] == [[], []] and len(got["episodes"]) == 1
    live = port.state_dict()  # the live buffer keeps its open episodes
    _states_equal(live, episode_buffer_from_jax(jax_rb))
    assert all(len(chunks) > 0 for chunks in live["open"])


def test_torch_ckpt_truncation_async_save_leaves_the_live_buffer(tmp_path):
    rng = np.random.default_rng(6)
    port = ReplayBuffer(SIZE, N_ENVS, memmap=True, memmap_dir=tmp_path / "rb")
    for _ in range(SIZE + 3):
        port.add(_rows(rng, N_ENVS, np.uint8))
    live = {k: v.clone() for k, v in port.state_dict()["buffer"].items()}
    manager = CheckpointManager(async_save=True)
    path = manager.save(tmp_path / "ckpt" / "ckpt_1_0.ckpt", {"rb": port.checkpoint_state_dict()}, step=1)
    manager.close()
    saved = load_checkpoint(path)["rb"]["buffer"]
    assert saved["truncated"][(port.pos - 1) % SIZE].tolist() == [[1]] * N_ENVS
    assert int(saved["truncated"].sum()) == N_ENVS
    for k, v in port.state_dict()["buffer"].items():
        assert torch.equal(v, live[k]), k


def test_torch_ckpt_truncation_sac_run_saves_the_patched_buffer(tmp_path):
    from tests.test_torch_sac_loop import TINY

    s = cli.run(["preset=sac"] + TINY + ["algo.total_steps=80", f"log_root={tmp_path}"])
    truncated = load_checkpoint(s["checkpoint"])["rb"]["buffer"]["truncated"]
    assert truncated.shape[0] == 40 and truncated[-1].tolist() == [[1], [1]] and int(truncated.sum()) == 2


def test_torch_ckpt_truncation_rssm_host_run_saves_the_patched_buffer(tmp_path):
    from tests.test_torch_train_loop import TINY_RUN

    s = cli.run(TINY_RUN + ["env.num_envs=2", "algo.total_steps=16", "algo.learning_starts=8",
                            "algo.run_test=false", "buffer.checkpoint=true", f"log_root={tmp_path}"])
    envs = load_checkpoint(s["checkpoint"])["rb"]["envs"]
    for env in envs:
        truncated = env["buffer"]["truncated"]
        assert truncated[(env["pos"] - 1) % truncated.shape[0]].item() == 1
