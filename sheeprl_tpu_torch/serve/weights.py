"""Versioned hot-swappable serving weights (counterpart of
``sheeprl_tpu/serve/weights.py``, ``WeightStore``).

Newest wins: the scheduler pulls one ``(version, params)`` snapshot per
batch and serves every row of the batch under it, so a swap never tears a
request. A published params object is never changed afterwards; a swap
publishes a new one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple

__all__ = ["WeightStore"]


class WeightStore:
    """``params_from_state`` (usually ``StatefulServePolicy.params_from_state``)
    turns a checkpoint state into servable params for :meth:`publish_state`;
    :meth:`publish_params` takes params that are already built."""

    def __init__(self, params: Any, params_from_state: Optional[Callable[[Any], Any]] = None) -> None:
        self._lock = threading.Lock()
        self._params = params
        self._version = 0  # the construction-time params; publishes are >= 1
        self._params_from_state = params_from_state
        self._published_at = time.monotonic()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def staleness_s(self) -> float:
        """Seconds since the last publish (construction counts as one)."""
        with self._lock:
            return max(0.0, time.monotonic() - self._published_at)

    def pull(self) -> Tuple[int, Any]:
        with self._lock:
            return self._version, self._params

    def publish_params(self, params: Any) -> int:
        with self._lock:
            self._params = params
            self._version += 1
            self._published_at = time.monotonic()
            return self._version

    def publish_state(self, state: Any) -> int:
        if self._params_from_state is None:
            raise RuntimeError("this WeightStore was built without a params_from_state converter")
        return self.publish_params(self._params_from_state(state))
