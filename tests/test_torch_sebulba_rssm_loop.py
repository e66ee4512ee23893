"""``run preset=dreamer_sebulba_atari_dummy`` (the port's async DreamerV3 on
the Sebulba pipeline) through ``cli.run`` on the CPU, at the tiny widths of
``tests/test_torch_train_loop.py``, with JAX's loop tests as the bar
(``tests/test_algos/test_dreamer_sebulba.py``,
``tests/test_fault/test_chaos_dreamer_sebulba.py``); no JAX runs here.

- The preset is JAX ``exp=dreamer_sebulba``'s recipe at DreamerV3-S widths.
- The replay-ratio governor: ``|grad steps - ratio (consumed - prefill)| <=
  ratio + 1`` at ratio 2.
- The ring is the storage tier: an over-budget ring and a ring too small
  for one block raise JAX's named errors.
- A checkpoint, then ``resume_from=latest``: the ring, its heads, its
  generator and ``Ratio`` restored exactly; the run goes on training.
- ``evaluation`` and one served session step work on its checkpoint.
- An actor killed at ``dreamer_sebulba.actor1.step`` restarts, and the
  run's counters equal its clean twin's.
- A ``dry_run`` and a ``bf16-mixed`` run.
Every wait carries its own limit (``fault.supervisor.join_s``).
"""

import glob
import importlib
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.replay import DeviceReplayState
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_train_loop import TINY_RUN

seb = importlib.import_module("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba")

FAST = ["preset=dreamer_sebulba_atari_dummy"] + TINY_RUN[1:] + [
    "env.num_envs=2", "buffer.size=256", "algo.sebulba.rollout_block=4", "algo.learning_starts=16",
    "algo.run_test=false", "checkpoint.save_last=false", "checkpoint.every=0", "fault.supervisor.join_s=5",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inject.reset()
    yield
    inject.reset()
    torch.set_num_threads(n)


def _ckpts(root):
    return sorted(glob.glob(f"{root}/**/ckpt_*.ckpt", recursive=True), key=os.path.getmtime)


def test_torch_sebulba_rssm_loop_preset_is_the_recipe():
    cfg = preset("dreamer_sebulba_atari_dummy")
    assert cfg.algo.name == "dreamer_sebulba" and cfg.algo.sebulba == {
        "num_actor_threads": 2, "queue_depth": 2, "publish_every": 1, "actor_devices": "auto", "rollout_block": 8}
    assert (cfg.env.num_envs, cfg.algo.replay_ratio, cfg.algo.learning_starts) == (4, 1, 1024)
    assert (cfg.algo.per_rank_batch_size, cfg.algo.per_rank_sequence_length, cfg.algo.horizon) == (16, 64, 15)
    assert cfg.buffer.checkpoint and cfg.buffer.size == 100000 and cfg.fabric.precision == "32-true"
    wm = cfg.algo.world_model
    assert (cfg.algo.dense_units, wm.recurrent_model.recurrent_state_size, wm.encoder.cnn_channels_multiplier,
            wm.stochastic_size, wm.discrete_size) == (512, 512, 32, 32, 32)
    assert cfg.preset.reduced and cfg.preset.substitutions


def test_torch_sebulba_rssm_loop_governor_holds_the_replay_ratio(tmp_path):
    ratio = 2.0
    out = cli.run(FAST + [f"log_root={tmp_path}", "env.num_envs=1", f"algo.replay_ratio={ratio}",
                          "algo.learning_starts=8", "algo.total_steps=64"])
    pipe = out["pipeline"]
    consumed, grads = pipe["Pipeline/env_steps_consumed"], pipe["Pipeline/grad_steps"]
    assert consumed >= 64 and grads == out["gradient_steps"] > 0
    assert abs(grads - ratio * (consumed - out["prefill_policy_steps"])) <= ratio + 1, (grads, consumed)
    assert pipe["Pipeline/replay_ratio_actual"] == pytest.approx(grads / consumed, abs=1e-3)
    assert len(out["metrics"]) == out["train_calls"] and np.isfinite(np.asarray(out["metrics"])).all()
    assert len(out["metrics"][0]) == 11  # the ten losses and the guard's skipped share
    assert out["replay"]["Replay/flushes"] == pipe["Pipeline/rollouts_consumed"]
    assert out["act_steps"] > 0 and pipe["staleness_max"] <= 2 * pipe["staleness_bound"] + pipe["prefill_publishes"]


def test_torch_sebulba_rssm_loop_ring_sizing_raises_by_name(tmp_path):
    with pytest.raises(RuntimeError, match="dreamer_sebulba streams sequence heads"):
        cli.run(FAST + [f"log_root={tmp_path}/a", "buffer.hbm_budget_gb=1e-9", "algo.total_steps=32"])
    with pytest.raises(ValueError, match="one rollout block can stage up to 8 rows"):
        cli.run(FAST + [f"log_root={tmp_path}/b", "buffer.size=24", "algo.per_rank_sequence_length=2",
                        "algo.total_steps=32"])


def test_torch_sebulba_rssm_loop_resume_from_latest_restores_the_ring_and_serves(tmp_path, monkeypatch):
    first = cli.run(FAST + [f"log_root={tmp_path}", "algo.total_steps=64", "checkpoint.every=32",
                            "checkpoint.save_last=true", "seed=11"])
    ckpts = _ckpts(tmp_path)
    assert [os.path.basename(c) for c in ckpts] == ["ckpt_32_0.ckpt", "ckpt_64_0.ckpt"]
    saved = load_checkpoint(ckpts[-1])
    assert {"world_model", "actor", "critic", "target_critic", "optimizers", "moments", "ratio", "iter_num",
            "batch_size", "last_log", "last_checkpoint", "train_step", "rng", "actor_rng", "rb"} == set(saved)
    snap = DeviceReplayState.from_dict(saved["rb"])
    assert snap.kind == "sequence" and int(snap.arrays["valid"].sum()) == first["replay"]["Replay/size"]
    restored = {}

    class _Recording(seb.AsyncSequenceRing):
        def load_state_dict(self, s):
            super().load_state_dict(s)
            restored.update(self.state_dict().arrays)
            return self

    class _RecordingRatio(seb.Ratio):
        def load_state_dict(self, s):
            super().load_state_dict(s)
            restored["ratio"] = self.state_dict()
            return self

    monkeypatch.setattr(seb, "AsyncSequenceRing", _Recording)
    monkeypatch.setattr(seb, "Ratio", _RecordingRatio)
    resumed = cli.run(FAST + [f"log_root={tmp_path}", "checkpoint.resume_from=latest", "algo.total_steps=128",
                              "algo.learning_starts=0", "checkpoint.save_last=true", "seed=11"])
    assert set(restored) == set(snap.arrays) | {"ratio"}
    for k, v in snap.arrays.items():
        assert torch.equal(restored[k], v), k
    assert restored["ratio"] == saved["ratio"]
    assert resumed["start_iter"] == 33 and resumed["policy_steps"] == 128 and resumed["gradient_steps"] > 0
    last = load_checkpoint(resumed["checkpoint"])
    assert torch.equal(last["actor_rng"], saved["actor_rng"])
    assert int(DeviceReplayState.from_dict(last["rb"]).arrays["valid"].sum()) == 128  # the pre-resume rows stayed

    result = cli.evaluation([f"checkpoint_path={resumed['checkpoint']}", "fabric.accelerator=cpu"])
    assert result["device"] == "cpu" and result["steps"] > 0
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    serve_cfg = cli.compose_serve_config([f"checkpoint_path={resumed['checkpoint']}", "fabric.accelerator=cpu"])
    policy = resolve_policy_builder(serve_cfg.algo.name)(serve_cfg, last, torch.device("cpu"))
    rows = {k: torch.from_numpy(v) for k, v in
            policy.prepare({"rgb": np.zeros((2, 64, 64, 3), np.uint8)}, 2).items()}
    with torch.no_grad():
        actions, state = policy.step_fn(policy.params, rows, policy.init_fn(policy.params, 2), True)
    assert serve_cfg.algo.name == "dreamer_sebulba" and actions.shape == (2, 1) and int(state["counter"][0]) == 1


CHAOS = FAST + ["env.num_envs=1", "algo.learning_starts=4", "algo.total_steps=48",
                "algo.sebulba.num_actor_threads=3", "fault.supervisor.backoff=0.0"]


def test_torch_sebulba_rssm_loop_killed_actor_restarts_with_the_clean_counters(tmp_path):
    clean = cli.run(CHAOS + [f"log_root={tmp_path}/clean"])
    assert clean["pipeline"]["Pipeline/actor_deaths"] == 0 and clean["pipeline"]["Pipeline/actors_live"] == 3
    inject.arm("dreamer_sebulba.actor1.step", action="raise", at=10)
    with pytest.warns(UserWarning, match="dreamer-sebulba-actor-1.*restarting"):
        chaos = cli.run(CHAOS + [f"log_root={tmp_path}/chaos"])
    pipe = chaos["pipeline"]
    assert pipe["Pipeline/actor_deaths"] == 1 and pipe["Pipeline/actor_restarts"] == 1
    assert pipe["Pipeline/actors_live"] == 3
    assert chaos["policy_steps"] == clean["policy_steps"]
    assert pipe["Pipeline/env_steps_consumed"] == clean["pipeline"]["Pipeline/env_steps_consumed"]


def test_torch_sebulba_rssm_loop_dry_run_and_bf16(tmp_path):
    dry = cli.run(FAST + [f"log_root={tmp_path}/a", "dry_run=true", "algo.per_rank_sequence_length=2"])
    assert dry["policy_steps"] == 4 * 2 and dry["iterations"] == 4
    bf16 = cli.run(FAST + [f"log_root={tmp_path}/b", "fabric.precision=bf16-mixed", "algo.total_steps=48"])
    assert bf16["gradient_steps"] > 0 and np.isfinite(np.asarray(bf16["metrics"])).all()
