"""Iteration-windowed ``torch.profiler`` traces (counterpart of
``sheeprl_tpu/utils/profiler.py``).

Config surface (group ``metric``)::

    profiler:
      enabled: False
      start_iter: 8      # first traced iteration (lets kernel builds and warm-up finish)
      num_iters: 4       # how many iterations to capture

The trace is a Chrome/Perfetto JSON under ``<log_dir>/profiler``
(``trace_<first>_<stop>.json``: the window's first iteration and the one it
stopped at), with the host's CPU activity and, when the run's device is a
CUDA card, the card's kernels and copies. It opens in ``chrome://tracing``
or Perfetto.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional, Tuple

__all__ = ["TraceProfiler"]


class TraceProfiler:
    """Call :meth:`tick` once per training iteration (or block); the trace
    starts at the first tick with ``iter_num >= start_iter`` and stops at
    the first tick at or past ``start_iter + num_iters`` counted from the
    iteration it started at; :meth:`close` stops a window that is still
    open. Disabled, it imports nothing, launches nothing and writes
    nothing."""

    def __init__(self, cfg: Optional[Mapping[str, Any]], log_dir: str, device: Any = "cpu") -> None:
        prof_cfg = dict(cfg or {})
        self.enabled = bool(prof_cfg.get("enabled", False))
        self.start_iter = int(prof_cfg.get("start_iter", 8))
        self.num_iters = int(prof_cfg.get("num_iters", 4))
        self.trace_dir = os.path.join(log_dir, "profiler")
        self.cuda = str(device).startswith("cuda")
        self.window: Optional[Tuple[int, int]] = None  # (first traced iteration, the one the trace stopped at)
        self.trace_path: Optional[str] = None
        self._prof = None
        self._first = 0
        self._stop_at = 0
        self._done = False

    def tick(self, iter_num: int) -> None:
        if not self.enabled or self._done:
            return
        if self._prof is None and iter_num >= self.start_iter:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._first, self._stop_at = int(iter_num), int(iter_num) + self.num_iters
        elif self._prof is not None and iter_num >= self._stop_at:
            self._stop(int(iter_num))

    def _stop(self, iter_num: int) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        self.window = (self._first, iter_num)
        self.trace_path = os.path.join(self.trace_dir, f"trace_{self._first}_{iter_num}.json")
        prof.export_chrome_trace(self.trace_path)
        self._done = True

    def close(self, iter_num: Optional[int] = None) -> None:
        """Stop a window that is still open (at the end of the run, the
        ``iter_num`` it ended at)."""
        if self._prof is not None:
            self._stop(self._stop_at if iter_num is None else int(iter_num))
