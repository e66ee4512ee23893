"""Host-clock timers (counterpart of ``sheeprl_tpu/utils/timer.py``).

A context manager and decorator that adds the seconds it encloses to a named
metric in a class-level table; the training loops derive
``Time/sps_train`` and ``Time/sps_env_interaction`` from the table at each
log point. ``timer.disabled`` (set by ``run`` from ``metric.disable_timer``
and ``metric.log_level``) turns every timer into a no-op.

A timer reads ``time.perf_counter`` and never synchronises the device: on
the card it measures the host's time inside the block, which covers the
device's work only where the block itself waits for it (a copy to the host).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Dict, Optional, Type

from sheeprl_tpu_torch.utils.metric import Metric, SumMetric

__all__ = ["timer", "TimerError", "log_timers"]


class TimerError(Exception):
    """Raised on misuse of a timer."""


class timer(ContextDecorator):
    disabled: bool = False
    timers: Dict[str, Metric] = {}

    def __init__(self, name: str, metric: Optional[Type[Metric]] = None, **kwargs) -> None:
        self.name = name
        self._start_time: Optional[float] = None
        if not timer.disabled and name is not None and name not in timer.timers:
            timer.timers[name] = (metric or SumMetric)(**kwargs)

    def start(self) -> None:
        if self._start_time is not None:
            raise TimerError("timer is running. Use .stop() to stop it")
        self._start_time = time.perf_counter()

    def stop(self) -> float:
        if self._start_time is None:
            raise TimerError("timer is not running. Use .start() to start it")
        elapsed = time.perf_counter() - self._start_time
        self._start_time = None
        if self.name:
            timer.timers[self.name].update(elapsed)
        return elapsed

    @classmethod
    def reset(cls) -> None:
        for t in cls.timers.values():
            t.reset()

    @classmethod
    def compute(cls) -> Dict[str, float]:
        return {k: float(v.compute()) for k, v in cls.timers.items()}

    def __enter__(self) -> "timer":
        if not timer.disabled:
            self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        if not timer.disabled:
            self.stop()


def log_timers(logger, step: int, train_steps: int, env_steps: int) -> None:
    """The JAX loops' rates since the last log point, from the timers, which
    it then resets: ``Time/sps_train``, ``train_steps`` over
    ``Time/train_time``, and ``Time/sps_env_interaction``, ``env_steps`` over
    ``Time/env_interaction_time``; each only when its timer ran."""
    if timer.disabled:
        return
    times = timer.compute()
    if times.get("Time/train_time", 0) > 0:
        logger.log_dict({"Time/sps_train": train_steps / times["Time/train_time"]}, step)
    if times.get("Time/env_interaction_time", 0) > 0:
        logger.log_dict({"Time/sps_env_interaction": env_steps / times["Time/env_interaction_time"]}, step)
    timer.reset()
