"""Dreamer V1's and Plan2Explore-on-V1's hybrid host player through
``cli.run`` on the CPU, at the tiny widths of
``tests/test_torch_rssm_v1_loop.py``.

With ``algo.hybrid_player.enabled=true`` each exploration-side run resolves
on, as JAX's does, on a ring without ``is_first``; it takes every grant the
coupled run takes, in ``ceil(G / 4)`` bursts; each flushed row ends in the
player's ``Params/exploration_amount``; a checkpoint holds the host buffer
and a resume mirrors it into the ring and trains. The finetuning run from
the hybrid exploration's checkpoint stays coupled under ``true``: no
flush, no snapshot.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_rssm_v1_loop import TINY

HYBRID = TINY + ["algo.hybrid_player.enabled=true", "algo.hybrid_player.train_every=16", "algo.replay_ratio=0.25",
                 "algo.run_test=false", "checkpoint.save_last=true", "algo.learning_starts=32",
                 "algo.per_rank_pretrain_steps=0", "algo.total_steps=96"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRESETS = {"v1": "dreamer_v1_atari_dummy", "explore_v1": "p2e_dv1_exploration_atari_dummy"}


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """Each family's hybrid run, its coupled twin and their log root."""
    out = {}
    for family, name in PRESETS.items():
        log_root = tmp_path_factory.mktemp(family)
        base = HYBRID + [f"preset={name}", f"log_root={log_root}"]
        out[family] = (cli.run(base), cli.run(base + ["algo.hybrid_player.enabled=false"]), log_root)
    return out


@pytest.fixture(params=sorted(PRESETS))
def runs(request, all_runs):
    return all_runs[request.param]


def test_torch_hybrid_v1_loop_trains_the_coupled_grants_in_bursts(runs):
    s, coupled, _ = runs
    assert s["hybrid"] and not coupled["hybrid"] and s["grad_chunk"] == 4
    assert s["gradient_steps"] == coupled["gradient_steps"] > 8
    assert s["bursts"] == s["train_calls"] == -(-s["gradient_steps"] // 4) == len(s["metrics"])
    assert s["metric_names"] == coupled["metric_names"] and s["metric_names"][-1] == "Params/exploration_amount"
    rows = np.asarray(s["metrics"])
    assert np.isfinite(rows).all() and (rows[:, -1] == 0.3).all()  # the presets' expl_amount


def test_torch_hybrid_v1_loop_resumes_onto_the_ring(runs):
    s, _, log_root = runs
    env = load_checkpoint(s["checkpoint"])["rb"]["envs"][0]
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=192", "algo.learning_starts=8",
                       "fabric.accelerator=cpu", f"log_root={log_root}"])
    assert resumed["hybrid"] and resumed["ring_restored"] == [[int(env["pos"])], [int(env["pos"])]]
    assert resumed["bursts"] >= 1 and np.isfinite(np.asarray(resumed["metrics"])).all()


def test_torch_hybrid_v1_loop_finetuning_stays_coupled_under_true(all_runs, tmp_path):
    s, _, _ = all_runs["explore_v1"]
    f = cli.run(["preset=p2e_dv1_finetuning_atari_dummy"] + HYBRID + [
        f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "algo.learning_starts=8", "algo.total_steps=24",
        f"log_root={tmp_path}"])
    assert not f["hybrid"] and "bursts" not in f and f["train_calls"] > 0 and f["switched_at"] is not None
