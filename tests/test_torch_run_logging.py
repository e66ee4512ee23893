"""The loops' logging against the JAX loops': tiny PPO and SAC runs at
``metric.log_level=1``, on the CPU, write ``metrics.jsonl`` with the same
key set at the same policy steps, log point by log point, as the JAX loops
hand their logger (``Params/replay_ratio`` exactly equal; episodes are cut
at 10 steps, so every log window holds finished episodes in both); at
``log_level=0`` no ``metrics.jsonl`` is written and the timers stay off.
The run directory holds the run's ``config.json`` and ``hparams.json``."""

import json
from pathlib import Path

import pytest
import torch

import sheeprl_tpu.algos.ppo.ppo as jax_ppo
import sheeprl_tpu.algos.sac.sac as jax_sac
from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils import metric as tm
from sheeprl_tpu_torch.utils.logger import HPARAMS_NAME, METRICS_NAME
from sheeprl_tpu_torch.utils.timer import timer

COMMON = ["env.num_envs=2", "env.max_episode_steps=10", "algo.total_steps=64", "checkpoint.every=1000",
          "checkpoint.save_last=false", "algo.run_test=false", "metric.log_level=1"]
PPO = ["algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "buffer.size=8",
       "metric.log_every=32"]
SAC = ["algo.per_rank_batch_size=8", "algo.hidden_size=16", "algo.actor.hidden_size=16",
       "algo.critic.hidden_size=16", "algo.learning_starts=16", "buffer.size=256", "metric.log_every=16"]
JAX_EXTRA = ["env.sync_env=True", "env.capture_video=False", "buffer.memmap=False", "fabric.accelerator=cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    log_dir = None

    def __init__(self):
        self.rows = []

    def log_dict(self, metrics, step):
        if metrics:  # the JSON-lines writer writes no empty line
            self.rows.append({"step": int(step), **{k: float(v) for k, v in metrics.items()}})

    def log_hyperparams(self, params):
        pass

    def close(self):
        pass


def _jax_rows(monkeypatch, module, args, tmp_path):
    rec = _Recorder()
    monkeypatch.setattr(module, "get_logger", lambda cfg, log_dir, rank=0: rec)
    jax_cli.run(args + JAX_EXTRA + [f"log_root={tmp_path / 'jax'}"])
    return rec.rows


def _port_rows(summary):
    with open(Path(summary["log_dir"]) / METRICS_NAME) as f:
        return [json.loads(line) for line in f]


def _keys_by_point(rows):
    return [(r["step"], sorted(k for k in r if k != "step")) for r in rows]


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_torch_run_logging_writes_the_jax_loops_keys_at_the_jax_loops_steps(algo, tmp_path, monkeypatch):
    if algo == "ppo":
        jax = _jax_rows(monkeypatch, jax_ppo, ["exp=ppo", *COMMON, *PPO], tmp_path)
        port = cli.run(["preset=ppo", "fabric.accelerator=cpu", *COMMON, *PPO, f"log_root={tmp_path}"])
    else:
        jax = _jax_rows(monkeypatch, jax_sac, ["exp=sac", "env.id=Pendulum-v1", *COMMON, *SAC], tmp_path)
        port = cli.run(["preset=sac", "fabric.accelerator=cpu", *COMMON, *SAC, f"log_root={tmp_path}"])
    rows = _port_rows(port)
    assert _keys_by_point(rows) == _keys_by_point(jax)
    ratio = [(r["step"], r["Params/replay_ratio"]) for r in rows if "Params/replay_ratio" in r]
    assert ratio == [(r["step"], r["Params/replay_ratio"]) for r in jax if "Params/replay_ratio" in r]
    assert len(ratio) == (4 if algo == "sac" else 0)
    if algo == "ppo":  # the schedule's values too: nothing anneals in this preset
        info = [(r["step"], r["Info/learning_rate"], r["Info/clip_coef"]) for r in rows if "Info/learning_rate" in r]
        assert info == [(r["step"], r["Info/learning_rate"], r["Info/clip_coef"]) for r in jax if "Info/clip_coef" in r]
    log_dir = Path(port["log_dir"])
    assert log_dir.name == "version_0" and log_dir.parent.parent == tmp_path / algo / ("CartPole-v1" if algo == "ppo"
                                                                                          else "Pendulum-v1")
    hparams = json.loads((log_dir / HPARAMS_NAME).read_text())
    config = json.loads((log_dir / "config.json").read_text())
    assert hparams["run_name"] == config["run_name"] == log_dir.parent.name and "spaces" in config


def test_torch_run_logging_level_zero_writes_no_metrics_and_stops_the_timers(tmp_path, monkeypatch):
    monkeypatch.setattr(timer, "timers", {})
    s = cli.run(["preset=ppo", "fabric.accelerator=cpu", *COMMON, *PPO, "metric.log_level=0", f"log_root={tmp_path}"])
    log_dir = Path(s["log_dir"])
    assert not (log_dir / METRICS_NAME).exists() and not (log_dir / HPARAMS_NAME).exists()
    assert (log_dir / "config.json").exists()
    assert timer.disabled and timer.timers == {} and tm.MetricAggregator.disabled
    # disable_timer=false keeps the timers on at log_level 0, as in the JAX package
    cli.run(["preset=ppo", "fabric.accelerator=cpu", *COMMON, *PPO, "metric.log_level=0",
             "metric.disable_timer=false", f"log_root={tmp_path}"])
    assert not timer.disabled and set(timer.timers) == {"Time/env_interaction_time", "Time/train_time"}


def test_torch_run_logging_reads_the_losses_once_per_iteration(tmp_path, monkeypatch):
    """Logging adds no read of the device: the PPO update's losses reach the
    aggregator as the numbers of the iteration's one read, never as a
    tensor."""
    seen = []
    real = tm.MetricAggregator.update

    def spy(self, name, value):
        seen.append(type(value))
        return real(self, name, value)

    monkeypatch.setattr(tm.MetricAggregator, "update", spy)
    cli.run(["preset=ppo", "fabric.accelerator=cpu", *COMMON, *PPO, f"log_root={tmp_path}"])
    assert seen and not any(issubclass(t, torch.Tensor) for t in seen)
