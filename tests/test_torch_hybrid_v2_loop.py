"""Dreamer V2's hybrid host player through ``cli.run`` on the CPU, at the
tiny widths of ``tests/test_torch_rssm_v2_loop.py``.

``algo.hybrid_player.enabled=true`` turns the path on off the card too, as
in JAX: the player acts on its CPU copy of the subset, the rows go to the
ring in flushes and the trainer thread takes the grants in bursts of
``replay_ratio x num_envs x train_every`` (4) steps. The run takes every
grant the coupled run takes, in ``ceil(G / 4)`` bursts. On the sequential
buffer a checkpoint holds the host buffer, and a resume mirrors it into the
ring and trains; on the episode buffer the windows follow the episode rule,
a resume with ``buffer.checkpoint`` warns and trains coupled, and
``buffer.prioritize_ends`` raises under ``true`` and warns and trains
coupled under ``auto``.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_rssm_v2_loop import TINY

HYBRID = TINY + ["algo.hybrid_player.enabled=true", "algo.hybrid_player.train_every=16", "algo.replay_ratio=0.25",
                 "algo.run_test=false", "checkpoint.save_last=true"]
SEQ = HYBRID + ["preset=dreamer_v2_atari_dummy", "algo.learning_starts=32", "algo.total_steps=96"]
# the episode buffer samples stored (ended) episodes: the dummy env's first ends at step 366 (seed 5)
EPISODE = HYBRID + ["preset=dreamer_v2_ms_pacman_dummy", "buffer.prioritize_ends=false", "algo.learning_starts=368",
                    "algo.total_steps=420"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    log_root = tmp_path_factory.mktemp("hybrid_v2")
    hybrid = cli.run(SEQ + [f"log_root={log_root}"])
    coupled = cli.run(SEQ + ["algo.hybrid_player.enabled=false", f"log_root={log_root}"])
    return hybrid, coupled, log_root


def test_torch_hybrid_v2_loop_trains_the_coupled_grants_in_bursts(seq):
    s, coupled, _ = seq
    assert s["hybrid"] and not s["episode_rule"] and not coupled["hybrid"] and s["grad_chunk"] == 4
    assert s["gradient_steps"] == coupled["gradient_steps"] > 8 and s["cum"] == s["gradient_steps"]
    assert s["bursts"] == s["train_calls"] == -(-s["gradient_steps"] // 4) == len(s["metrics"])
    assert s["metric_names"] == list(dreamer_v2.METRIC_NAMES) and np.isfinite(np.asarray(s["metrics"])).all()
    assert len(s["act_host_s"]) == s["player_steps"] == 96 - 32  # the host player acts after learning_starts


def test_torch_hybrid_v2_loop_resumes_onto_the_ring(seq):
    s, _, log_root = seq
    saved = load_checkpoint(s["checkpoint"])
    env = saved["rb"]["envs"][0]
    assert saved["cum"] == s["gradient_steps"] and saved["host_rng"] is not None
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=192", "algo.learning_starts=8",
                       "fabric.accelerator=cpu", f"log_root={log_root}"])
    assert resumed["hybrid"] and resumed["ring_restored"] == [[int(env["pos"])], [int(env["pos"])]]
    assert resumed["cum_restored"] == s["gradient_steps"] and resumed["bursts"] >= 1
    assert resumed["cum"] == s["gradient_steps"] + resumed["gradient_steps"]


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    log_root = tmp_path_factory.mktemp("hybrid_v2_episode")
    return cli.run(EPISODE + [f"log_root={log_root}", "seed=5"]), log_root


def test_torch_hybrid_v2_loop_episode_buffer_rides_the_episode_rule(episode, monkeypatch):
    s, log_root = episode
    assert s["hybrid"] and s["episode_rule"] and s["buffer_type"] == "episode" and s["bursts"] >= 2
    assert np.isfinite(np.asarray(s["metrics"])).all()
    with pytest.warns(UserWarning, match="cannot mirror the device ring"):
        resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=440",
                           "algo.learning_starts=8", "fabric.accelerator=cpu", f"log_root={log_root}"])
    assert not resumed["hybrid"] and resumed["train_calls"] >= 1


def test_torch_hybrid_v2_loop_prioritize_ends_raises_or_trains_coupled(tmp_path, monkeypatch):
    ends = [a for a in EPISODE if not a.startswith("buffer.prioritize_ends")] + [
        "buffer.prioritize_ends=true", "algo.total_steps=8", f"log_root={tmp_path}"]
    with pytest.raises(ValueError, match="prioritize_ends"):
        cli.run(ends)
    # auto: on the card it resolves on, then warns and trains coupled
    monkeypatch.setattr(dreamer_v2, "resolve_hybrid_player", lambda hp_cfg, device: True)
    with pytest.warns(UserWarning, match="falling back to host-path sampling"):
        s = cli.run(ends + ["algo.hybrid_player.enabled=auto"])
    assert not s["hybrid"]
