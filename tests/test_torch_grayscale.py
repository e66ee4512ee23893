"""``env.grayscale`` on the Atari-protocol dummy, on the CPU:

- :func:`rgb_to_gray` is bit-equal to OpenCV's ``COLOR_RGB2GRAY`` on every
  one of the 2^24 RGB colours and on images of odd and SIMD-wide shapes;
- the port's gray dummy env gives frames bit-equal to the JAX env's
  (``cv2.resize`` with ``INTER_AREA``, then ``cv2.cvtColor``), shape
  ``(64, 64, 1)``, through resets, steps, life losses and episode ends;
- ``make_env`` builds it from ``env.grayscale=true``, its ``spaces`` say one
  channel, and a Dreamer encoder takes its input channels from them: a
  Dreamer V1 and a DreamerV3 dry run train on gray frames;
- ``env.grayscale`` still raises on every other port env.
"""

import cv2
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.dummy import AtariProtocolDummyEnv as JaxAtariDummy
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.envs import AtariProtocolDummyEnv, make_env, rgb_to_gray
from tests.test_torch_rssm_v1_loop import TINY as V1_TINY


def test_torch_grayscale_matches_opencv_on_every_colour():
    colours = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"), -1)
    image = colours.reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(rgb_to_gray(image)[..., 0], cv2.cvtColor(image, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (64, 64), (210, 160), (33, 65)])
def test_torch_grayscale_matches_opencv_on_images(shape):
    image = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,)).astype(np.uint8)
    got = rgb_to_gray(image)
    assert got.shape == shape + (1,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 0], cv2.cvtColor(image, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("seed", [0, 5])
def test_torch_grayscale_dummy_env_is_bit_equal_to_jax(seed):
    ours = AtariProtocolDummyEnv(screen_size=64, frame_skip=4, grayscale=True, life_len=40, seed=seed)
    theirs = JaxAtariDummy(screen_size=64, frame_skip=4, grayscale=True, life_len=40, seed=seed)
    assert ours.spaces["obs"]["rgb"]["shape"] == list(theirs.observation_space["rgb"].shape) == [64, 64, 1]
    a, b = ours.reset(seed=seed)[0]["rgb"], theirs.reset(seed=seed)[0]["rgb"]
    assert a.shape == (64, 64, 1) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    ends = 0
    for _ in range(120):
        action = int(rng.integers(0, 18))
        o, r, term, trunc, info = ours.step(action)
        o2, r2, term2, trunc2, info2 = theirs.step(action)
        np.testing.assert_array_equal(o["rgb"], o2["rgb"])
        assert (r, term, trunc, info["lives"]) == (r2, term2, trunc2, info2["lives"])
        if term:
            ends += 1
            np.testing.assert_array_equal(ours.reset()[0]["rgb"], theirs.reset()[0]["rgb"])
    assert ends >= 1  # the episodes of 3 short lives end inside the window


def test_torch_grayscale_make_env_builds_gray_frames():
    cfg = cli.compose_run_config(["preset=dreamer_v1_atari_dummy", "env.grayscale=true"])
    env = make_env(cfg, 3)
    assert env.spaces["obs"]["rgb"]["shape"] == [64, 64, 1]
    obs = env.reset(seed=3)[0]
    rgb = AtariProtocolDummyEnv(frame_skip=4, seed=3).reset(seed=3)[0]["rgb"]
    np.testing.assert_array_equal(obs["rgb"], cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)[..., None])


@pytest.mark.parametrize("preset,extra", [
    ("dreamer_v1_atari_dummy", V1_TINY),
    ("dreamer_v3_100k_atari_dummy", ["fabric.accelerator=cpu", "metric.log_level=0", "algo.dense_units=8",
                                     "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
                                     "algo.world_model.recurrent_model.recurrent_state_size=16",
                                     "algo.world_model.transition_model.hidden_size=8",
                                     "algo.world_model.representation_model.hidden_size=8",
                                     "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4",
                                     "algo.per_rank_batch_size=2", "env.num_envs=1", "algo.horizon=3"]),
], ids=["rssm_v1", "rssm_v3"])
def test_torch_grayscale_trains_a_dreamer(tmp_path, preset, extra):
    torch.manual_seed(0)
    summary = cli.run([f"preset={preset}"] + list(extra) + [
        "env.grayscale=true", "dry_run=true", "algo.per_rank_sequence_length=1", "algo.replay_ratio=1",
        "buffer.size=64", "algo.run_test=false", f"log_root={tmp_path}"])
    assert summary["gradient_steps"] == 1 and np.isfinite(np.asarray(summary["metrics"])).all()


@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy", "CartPole-v1"])
def test_torch_grayscale_raises_on_other_envs(env_id):
    cfg = cli.compose_run_config(["preset=ppo", f"env.id={env_id}", "env.grayscale=true"])
    with pytest.raises(NotImplementedError, match="grayscale"):
        make_env(cfg, 0)
