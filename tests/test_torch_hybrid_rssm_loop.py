"""DreamerV3's hybrid host player through ``cli.run`` on the CPU, at the
tiny widths of ``tests/test_torch_train_loop.py`` (a 64-row buffer).

``algo.hybrid_player.enabled=true`` turns the path on off the card too, as
in the JAX package: the player acts on its CPU copy of the modules, the
staged rows and the grants go to the trainer thread in bursts of
``replay_ratio x num_envs x train_every`` (16) gradient steps, and the run
takes every grant the coupled run takes (the tail flushed by ``finish``). The
burst count is the JAX harness's accounting for the same grants. A
checkpoint holds the host buffer (patched) and both generators; a resume
mirrors the buffer into the ring and trains a burst; a resident checkpoint
resumed onto the hybrid path fills the host buffer first.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_train_loop import TINY_RUN

HYBRID = TINY_RUN + ["algo.hybrid_player.enabled=true", "algo.run_test=false", "algo.learning_starts=8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    log_root = tmp_path_factory.mktemp("hybrid")
    return cli.run(HYBRID + ["algo.total_steps=64", f"log_root={log_root}"]), log_root


def test_torch_hybrid_rssm_loop_trains_the_coupled_grants_in_bursts(first, tmp_path):
    s, _ = first
    assert s["hybrid"] and not s["resident"] and s["grad_chunk"] == 16 and s["player_steps"] == 56
    coupled = cli.run(HYBRID + ["algo.total_steps=64", "algo.hybrid_player.enabled=false", f"log_root={tmp_path}"])
    assert not coupled["hybrid"] and coupled["gradient_steps"] == s["gradient_steps"] == 57
    # grants 1 a step from iteration 8: full chunks flushed at iterations 23, 39 and 55, the 9 left by finish
    assert s["bursts"] == s["train_calls"] == 4 and s["replay"]["Replay/flushes"] == 4
    assert len(s["metrics"]) == 4 and np.isfinite(np.asarray(s["metrics"])).all()
    assert [trained for _, trained in s["burst_host_s"]] == [True] * 4 and len(s["act_host_s"]) == 56
    # the host copy is the first pull's or the one refreshed after burst 4 (snapshot_every 4)
    assert s["snapshot_age"] in (0, 4) and s["snapshot"]["polls"] >= 1


def test_torch_hybrid_rssm_loop_checkpoints_and_resumes_onto_the_ring(first):
    s, log_root = first
    state = load_checkpoint(s["checkpoint"])
    assert state["host_rng"] is not None and state["rng"] is not None
    env = state["rb"]["envs"][0]
    # 64 rows in a 64-row buffer: full, the head back at 0, the newest row (63) patched truncated
    assert env["pos"] == 0 and env["full"] and env["buffer"]["truncated"][63].item() == 1
    # the restored Ratio grants again once the resumed run has caught up with the first run's grants
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=160", "algo.learning_starts=8",
                       "fabric.accelerator=cpu", f"log_root={log_root}"])
    assert resumed["hybrid"] and resumed["ring_restored"] == [[0], [64]]
    assert resumed["bursts"] == 3 and resumed["gradient_steps"] == 34


def test_torch_hybrid_rssm_loop_resident_checkpoint_resumes_hybrid(tmp_path):
    ring_run = cli.run(TINY_RUN + ["algo.run_test=false", "algo.learning_starts=8", "algo.total_steps=24",
                                   "buffer.device_resident=true", "algo.hybrid_player.enabled=false",
                                   f"log_root={tmp_path}"])
    assert ring_run["resident"] and "kind" in load_checkpoint(ring_run["checkpoint"])["rb"]
    resumed = cli.run([f"checkpoint.resume_from={ring_run['checkpoint']}", "algo.total_steps=48",
                       "algo.learning_starts=4", "algo.hybrid_player.enabled=true", "fabric.accelerator=cpu",
                       f"log_root={tmp_path}"])
    assert resumed["hybrid"] and not resumed["resident"] and resumed["ring_restored"] == [[24], [24]]
    assert resumed["gradient_steps"] > 0
