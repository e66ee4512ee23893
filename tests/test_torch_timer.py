"""The port's timers against the JAX package's (``sheeprl_tpu/utils/timer.py``):
one scripted clock drives both, and their tables are equal after every
step (exact: the same float64 sums); misuse raises the same ``TimerError``;
a disabled timer records nothing. ``configure_metrics`` applies the JAX
CLI's tri-state ``metric.disable_timer`` rule and its aggregator key filter
(``sheeprl_tpu/cli.py:244-256``), and ``log_timers`` logs the JAX loops'
``Time/sps_*`` rates."""

import itertools
import time

import pytest

from sheeprl_tpu.utils import metric as jax_metric
from sheeprl_tpu.utils.timer import TimerError as JaxTimerError
from sheeprl_tpu.utils.timer import timer as jax_timer
from sheeprl_tpu_torch.cli import configure_metrics
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils import metric as port_metric
from sheeprl_tpu_torch.utils.timer import TimerError, log_timers, timer

SCRIPT = [("Time/env_interaction_time", 0.25), ("Time/train_time", 1.5), ("Time/env_interaction_time", 0.125),
          ("Time/replay_path_time", 0.0625), ("Time/train_time", 3.0), ("Time/env_interaction_time", 2.0 ** -10)]


@pytest.fixture
def clean_tables(monkeypatch):
    for cls in (timer, jax_timer):
        monkeypatch.setattr(cls, "timers", {})
        monkeypatch.setattr(cls, "disabled", False)


def _scripted_clock(monkeypatch):
    """perf_counter reads 0, then each step's duration added, twice per
    block (start and stop)."""
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    return now


def test_torch_timer_tables_equal_jax_under_one_clock(clean_tables, monkeypatch):
    now = _scripted_clock(monkeypatch)
    for name, seconds in SCRIPT:
        for cls in (timer, jax_timer):
            with cls(name):
                now[0] += seconds
        assert timer.compute() == jax_timer.compute()
    assert timer.compute()["Time/train_time"] == 4.5
    assert [type(m).__name__ for m in timer.timers.values()] == [type(m).__name__ for m in jax_timer.timers.values()]
    timer.reset()
    jax_timer.reset()
    assert timer.compute() == jax_timer.compute() == {name: 0.0 for name, _ in SCRIPT}


def test_torch_timer_metric_kind_and_decorator_equal_jax(clean_tables, monkeypatch):
    now = _scripted_clock(monkeypatch)
    for cls, mod in ((timer, port_metric), (jax_timer, jax_metric)):
        @cls("Time/mean", mod.MeanMetric)
        def work():
            now[0] += 2.0

        work()
        work()
        with cls("Time/mean"):  # the first registration keeps its metric kind
            now[0] += 5.0
    assert timer.compute() == jax_timer.compute() == {"Time/mean": 3.0}


def test_torch_timer_misuse_raises_as_jax(clean_tables):
    for cls, err in ((timer, TimerError), (jax_timer, JaxTimerError)):
        t = cls("Time/x")
        with pytest.raises(err, match="timer is not running. Use .start\\(\\) to start it"):
            t.stop()
        t.start()
        with pytest.raises(err, match="timer is running. Use .stop\\(\\) to stop it"):
            t.start()


def test_torch_timer_disabled_records_nothing_as_jax(clean_tables, monkeypatch):
    for cls in (timer, jax_timer):
        monkeypatch.setattr(cls, "disabled", True)
        with cls("Time/x"):
            pass
        assert cls.timers == {} and cls.compute() == {}


@pytest.mark.parametrize("log_level,disable_timer", list(itertools.product([0, 1], [None, True, False])))
def test_torch_timer_tri_state_rule_is_the_jax_cli_s(clean_tables, monkeypatch, log_level, disable_timer):
    cfg = dotdict({"metric": {"log_level": log_level, "disable_timer": disable_timer, "aggregator": {"metrics": {
        "Rewards/rew_avg": {}, "Loss/value_loss": {}, "Loss/not_logged": {}}}}})
    monkeypatch.setattr(port_metric.MetricAggregator, "disabled", False)
    configure_metrics(cfg, {"Rewards/rew_avg", "Loss/value_loss"})
    # sheeprl_tpu/cli.py: timer.disabled = (log_level == 0) if disable_timer is None else bool(disable_timer)
    assert timer.disabled is ((log_level == 0) if disable_timer is None else bool(disable_timer))
    assert sorted(cfg.metric.aggregator.metrics) == ["Loss/value_loss", "Rewards/rew_avg"]
    assert port_metric.MetricAggregator.disabled is (log_level == 0)
    configure_metrics(cfg, set())
    assert port_metric.MetricAggregator.disabled  # nothing left to aggregate


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_dict(self, metrics, step):
        self.rows.append((step, dict(metrics)))


def test_torch_timer_log_timers_gives_the_jax_loops_rates(clean_tables, monkeypatch):
    now = _scripted_clock(monkeypatch)
    with timer("Time/train_time"):
        now[0] += 0.5
    with timer("Time/env_interaction_time"):
        now[0] += 0.25
    rec = _Recorder()
    log_timers(rec, 64, train_steps=4, env_steps=32)
    # the JAX loops: (train_step - last_train) / train_time and
    # (policy_step - last_log) * action_repeat / env_interaction_time
    assert rec.rows == [(64, {"Time/sps_train": 8.0}), (64, {"Time/sps_env_interaction": 128.0})]
    assert timer.compute() == {"Time/train_time": 0.0, "Time/env_interaction_time": 0.0}
    log_timers(rec, 128, train_steps=4, env_steps=32)  # neither timer ran: nothing logged
    assert len(rec.rows) == 2
    monkeypatch.setattr(timer, "disabled", True)
    log_timers(rec, 192, 1, 1)
    assert len(rec.rows) == 2
