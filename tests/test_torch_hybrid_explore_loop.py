"""The Plan2Explore exploration loops on Dreamer V2 and DreamerV3 with the
hybrid host player through ``cli.run`` on the CPU, at the tiny widths of
``tests/test_torch_rssm_v2_loop.py`` and ``tests/test_torch_finetune_handoff.py``.

With ``algo.hybrid_player.enabled=true`` each resolves on, as JAX's does:
the exploration actor acts on its CPU copy, the run takes every grant the
coupled run takes, in ``ceil(G / chunk)`` bursts whose metrics the steps
name (P2E-DV2's rows also end in ``Params/exploration_amount``); a
checkpoint holds the host buffer and a resume mirrors it into the ring and
trains. P2E-DV2 on the episode buffer warns and trains coupled. Each
finetuning run from the hybrid exploration's checkpoint stays coupled under
``true``.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import critics_spec, metric_names
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_finetune_handoff import TINY as TINY_V3
from tests.test_torch_rssm_v2_loop import TINY as TINY_V2

ON = ["algo.hybrid_player.enabled=true", "algo.run_test=false", "checkpoint.save_last=true"]
FAMILIES = {
    "explore_v2": (["preset=p2e_dv2_exploration_atari_dummy"] + TINY_V2 + ON + [
        "algo.hybrid_player.train_every=16", "algo.replay_ratio=0.25", "algo.learning_starts=32",
        "algo.per_rank_pretrain_steps=0", "algo.total_steps=96"], 4, "p2e_dv2_finetuning_atari_dummy"),
    "explore_v3": (["preset=p2e_dv3_exploration_atari_dummy"] + TINY_V3 + ON + [
        "metric.log_level=0", "env.num_envs=2", "algo.hybrid_player.train_every=2", "algo.total_steps=64"], 2,
        "p2e_dv3_finetuning_atari_dummy"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def runs(request, tmp_path_factory):
    log_root = tmp_path_factory.mktemp(request.param)
    base, chunk, finetune = FAMILIES[request.param]
    base = base + [f"log_root={log_root}"]
    return request.param, cli.run(base), cli.run(base + ["algo.hybrid_player.enabled=false"]), chunk, log_root


def test_torch_hybrid_explore_loop_trains_the_coupled_grants_in_bursts(runs):
    family, s, coupled, chunk, _ = runs
    assert s["hybrid"] and not coupled["hybrid"] and s["grad_chunk"] == chunk
    assert s["gradient_steps"] == coupled["gradient_steps"] > 8
    assert s["bursts"] == s["train_calls"] == -(-s["gradient_steps"] // chunk) == len(s["metrics"])
    rows = np.asarray(s["metrics"])
    assert np.isfinite(rows).all()
    if family == "explore_v2":
        assert s["metric_names"] == list(p2e_dv2_exploration.METRIC_NAMES) + ["Params/exploration_amount"]
        assert (rows[:, -1] == float(preset("p2e_dv2_exploration_atari_dummy").algo.actor.expl_amount)).all()
    else:
        assert s["metric_names"] == coupled["metric_names"] == metric_names(critics_spec(
            preset("p2e_dv3_exploration_atari_dummy")))


def test_torch_hybrid_explore_loop_resumes_onto_the_ring(runs):
    family, s, _, _, log_root = runs
    saved = load_checkpoint(s["checkpoint"])
    pos = [int(env["pos"]) for env in saved["rb"]["envs"]]
    total = 192 if family == "explore_v2" else 160
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", f"algo.total_steps={total}",
                       "algo.learning_starts=8", "fabric.accelerator=cpu", f"log_root={log_root}"])
    assert resumed["hybrid"] and resumed["ring_restored"][0] == pos and resumed["bursts"] >= 1
    assert np.isfinite(np.asarray(resumed["metrics"])).all()
    if family == "explore_v3":  # the Moments of the last burst went into the checkpoint
        assert set(saved["moments"]) == {"task", "exploration"}


def test_torch_hybrid_explore_loop_finetuning_stays_coupled_under_true(runs, tmp_path):
    family, s, _, _, _ = runs
    base, _, finetune = FAMILIES[family]
    f = cli.run([a for a in base if not a.startswith("preset=")] + [
        f"preset={finetune}", f"checkpoint.exploration_ckpt_path={s['checkpoint']}", "algo.learning_starts=8",
        "algo.total_steps=24", f"log_root={tmp_path}"])
    assert not f["hybrid"] and "bursts" not in f and f["train_calls"] > 0 and f["switched_at"] is not None


def test_torch_hybrid_explore_loop_episode_buffer_trains_coupled(tmp_path):
    base, _, _ = FAMILIES["explore_v2"]
    with pytest.warns(UserWarning, match="requires buffer.type=sequential"):
        s = cli.run(base + ["buffer.type=episode", "algo.total_steps=8", f"log_root={tmp_path}"])
    assert not s["hybrid"]
