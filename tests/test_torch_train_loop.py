"""The port's coupled training loop on the CPU: its env, vector env, replay
buffer and ``Ratio`` against the JAX package's, and a tiny ``run`` that
writes a checkpoint, resumes from it with its counters going on, and whose
checkpoint ``serve`` then answers from.

The env's observations, rewards and flags are compared exactly (the port
reproduces OpenCV's INTER_AREA resize in float32); buffer samples exactly;
``Ratio``'s grants and state dict exactly.
"""

import contextlib

import gymnasium as gym
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.envs.dummy import AtariProtocolDummyEnv as JaxAtariDummy
from sheeprl_tpu.envs.vector import FastSyncVectorEnv
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import serve_policy_dreamer_v3
from sheeprl_tpu_torch.config import load_config
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.envs import AtariProtocolDummyEnv, SyncVectorEnv, resize_area
from sheeprl_tpu_torch.serve.server import PolicyServer, request_over_socket
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from sheeprl_tpu_torch.utils.utils import Ratio

TINY_RUN = [
    "preset=dreamer_v3_100k_atari_dummy",
    "fabric.accelerator=cpu",
    "metric.log_level=0",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=4",
    "algo.horizon=3",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder={'cnn_channels_multiplier': 2, 'mlp_layers': 1, 'dense_units': 8}",
    "algo.world_model.recurrent_model={'recurrent_state_size': 16, 'dense_units': 8}",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.observation_model={'cnn_channels_multiplier': 2, 'mlp_layers': 1, 'dense_units': 8}",
    "algo.world_model.reward_model={'mlp_layers': 1, 'dense_units': 8, 'bins': 17}",
    "algo.world_model.discount_model={'mlp_layers': 1, 'dense_units': 8}",
    "algo.actor.mlp_layers=1",
    "algo.actor.dense_units=8",
    "algo.critic.mlp_layers=1",
    "algo.critic.dense_units=8",
    "algo.critic.bins=17",
    "algo.learning_starts=8",
    "buffer.size=64",
    "checkpoint.every=1000",
    "checkpoint.save_last=true",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_train_loop_env_matches_jax():
    """One seed, one action sequence, 500 steps through two episodes: every
    observation, reward and flag equal."""
    rng = np.random.default_rng(0)
    port, ref = AtariProtocolDummyEnv(seed=3, life_len=200), JaxAtariDummy(seed=3, life_len=200)
    got, want = port.reset(seed=3)[0], ref.reset(seed=3)[0]
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    episodes = 0
    for t in range(500):
        a = int(rng.integers(18))
        g, w = port.step(a), ref.step(a)
        np.testing.assert_array_equal(g[0]["rgb"], w[0]["rgb"], err_msg=f"step {t}")
        assert g[1:4] == w[1:4], t
        if w[2]:
            episodes += 1
            np.testing.assert_array_equal(port.reset()[0]["rgb"], ref.reset()[0]["rgb"])
    assert episodes >= 2


def test_torch_train_loop_area_resize_is_opencvs():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    for shape, size in (((210, 160, 3), 64), ((210, 160, 3), 32), ((97, 131, 1), 40)):
        image = rng.integers(0, 256, size=shape, dtype=np.uint8)
        want = cv2.resize(image, (size, size), interpolation=cv2.INTER_AREA).reshape(size, size, shape[2])
        np.testing.assert_array_equal(resize_area(image, size, size), want)


def test_torch_train_loop_vector_env_autoresets_like_jax():
    """SAME_STEP autoreset and the time limit: after an episode ends, the
    returned observation is the reset one and ``final_obs`` the last one."""
    limit = 30

    def jax_env(i):
        return lambda: gym.wrappers.TimeLimit(JaxAtariDummy(seed=7 + i, life_len=60), max_episode_steps=limit)

    ref = FastSyncVectorEnv([jax_env(i) for i in range(2)], autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    port = SyncVectorEnv([lambda i=i: AtariProtocolDummyEnv(seed=7 + i, life_len=60) for i in range(2)], limit)
    np.testing.assert_array_equal(port.reset(seed=7)[0]["rgb"], ref.reset(seed=7)[0]["rgb"])
    rng = np.random.default_rng(2)
    ends = 0
    for t in range(80):
        actions = rng.integers(0, 18, size=2)
        g_obs, g_rew, g_term, g_trunc, g_info = port.step(actions)
        w_obs, w_rew, w_term, w_trunc, w_info = ref.step(actions)
        np.testing.assert_array_equal(g_obs["rgb"], w_obs["rgb"], err_msg=f"step {t}")
        np.testing.assert_array_equal(g_rew, w_rew)
        np.testing.assert_array_equal(g_term, w_term)
        np.testing.assert_array_equal(g_trunc, w_trunc)
        for i in np.flatnonzero(np.logical_or(w_term, w_trunc)):
            ends += 1
            np.testing.assert_array_equal(g_info["final_obs"][i]["rgb"], w_info["final_obs"][i]["rgb"])
    port.close()
    ref.close()
    assert ends >= 3


def _fill(rb, rng_seed):
    rng = np.random.default_rng(rng_seed)
    for t in range(40):
        rb.add({
            "rgb": rng.integers(0, 256, (1, 3, 4, 4, 3), dtype=np.uint8),
            "rewards": rng.normal(size=(1, 3, 1)).astype(np.float32),
            "is_first": np.zeros((1, 3, 1), np.float32),
        })
        if t % 7 == 3:  # a ragged reset row for env 1 only
            rb.add({"rgb": np.zeros((1, 1, 4, 4, 3), np.uint8), "rewards": np.ones((1, 1, 1), np.float32),
                    "is_first": np.ones((1, 1, 1), np.float32)}, [1])
    rb.seed(5)
    return rb


def test_torch_train_loop_buffer_samples_match_jax():
    port = _fill(EnvIndependentReplayBuffer(24, n_envs=3, obs_keys=("rgb",)), 9)
    ref = _fill(JaxEnvIndependent(24, n_envs=3, obs_keys=("rgb",), buffer_cls=JaxSequential), 9)
    for n_samples in (1, 3):
        got = port.sample(5, sequence_length=6, n_samples=n_samples)
        want = ref.sample(5, sequence_length=6, n_samples=n_samples)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape == (n_samples, 6, 5, *want[k].shape[3:])
            np.testing.assert_array_equal(got[k], want[k])


def test_torch_train_loop_ratio_matches_jax():
    for ratio, pretrain in ((1.0, 0), (0.25, 0), (0.5, 8)):
        port, ref = Ratio(ratio, pretrain), JaxRatio(ratio, pretrain)
        for step in (1, 2, 3, 7, 8, 20, 21, 22, 40):
            with pytest.warns(UserWarning) if (pretrain and step == 1) else contextlib.nullcontext():
                g = port(step)
            with pytest.warns(UserWarning) if (pretrain and step == 1) else contextlib.nullcontext():
                w = ref(step)
            assert g == w, (ratio, pretrain, step)
            assert port.state_dict() == ref.state_dict()
        restored = Ratio(0.1).load_state_dict(ref.state_dict())
        assert restored.state_dict() == ref.state_dict() and restored(50) == ref(50)


def test_torch_train_loop_run_resume_and_serve(tmp_path):
    """A tiny run writes its last checkpoint; a second run resumes from it
    with the counters going on; ``serve`` answers from the resumed run's
    checkpoint. The first gradient step after a resume copies the critic into
    the target critic, as the JAX loop's (its step counter starts at 0 in
    every run)."""
    first = cli.run(TINY_RUN + [f"log_root={tmp_path}", "algo.total_steps=16"])
    assert first["device"] == "cpu" and first["policy_steps"] == 16
    assert first["gradient_steps"] == 9 and len(first["metrics"]) == 9  # iterations 8..16 at ratio 1
    assert np.isfinite(np.asarray(first["metrics"])).all()
    state = load_checkpoint(first["checkpoint"])
    assert set(state) == {"world_model", "actor", "critic", "target_critic", "optimizers", "moments", "ratio",
                          "iter_num", "batch_size", "last_log", "last_checkpoint", "train_step", "last_train", "rng",
                          "rb"}
    assert state["iter_num"] == 16
    assert not all(torch.equal(state["target_critic"][k], v) for k, v in state["critic"].items())

    # a resume takes algo.learning_starts afresh, as the JAX package's does
    resume = [f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
              "algo.learning_starts=8", f"log_root={tmp_path}"]
    # learning starts again 8 iterations after the resume; Ratio grants the first step at iteration 26
    once = cli.run(resume + ["algo.total_steps=26"])
    assert once["start_iter"] == 17 and once["gradient_steps"] == len(once["metrics"]) == 1
    after_one = load_checkpoint(once["checkpoint"])
    for k, v in state["critic"].items():
        torch.testing.assert_close(after_one["target_critic"][k], v, rtol=0, atol=0)

    second = cli.run(resume + ["algo.total_steps=40"])
    assert second["start_iter"] == 17 and second["policy_steps"] == 40
    assert second["gradient_steps"] == len(second["metrics"]) == 15  # iterations 26..40
    assert np.isfinite(np.asarray(second["metrics"])).all()
    resumed = load_checkpoint(second["checkpoint"])
    assert resumed["iter_num"] == 40 and resumed["ratio"]["_prev"] > state["ratio"]["_prev"]

    cfg = load_config(find_run_config(second["checkpoint"]))
    policy = serve_policy_dreamer_v3(cfg, resumed, "cpu")
    frame = np.zeros((64, 64, 3), np.uint8).tolist()
    with PolicyServer(policy, {"port": 0, "max_wait_ms": 1.0, "session": {"buckets": [1, 2]}}) as server:
        for t in range(4):
            resp = request_over_socket(server.address, {"obs": {"rgb": frame}, "session_id": "s"})
            (action,) = resp["actions"]
            assert len(action) == 1 and 0 <= action[0] < 18, resp


def test_torch_train_loop_run_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(TINY_RUN[:1] + [f"log_root={tmp_path}"])
