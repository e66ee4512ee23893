"""Host-side metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``).

Running statistics over Python numbers, numpy arrays and torch tensors,
accumulated in float64 on the host, and :class:`MetricAggregator`, the
name -> metric table the training loops update and the logger reads.

An ``update`` with a CUDA tensor copies it to the host, which waits for the
device: the loops pass the values they already read once per iteration or
per log interval, never a tensor per minibatch or per gradient step.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

__all__ = [
    "Metric",
    "MeanMetric",
    "SumMetric",
    "MaxMetric",
    "MinMetric",
    "LastValueMetric",
    "CatMetric",
    "MetricAggregator",
    "MetricAggregatorException",
    "RankIndependentMetricAggregator",
    "build_aggregator",
]


def _as_array(value: Any, dtype: Any = np.float64) -> np.ndarray:
    """A numpy array of ``value`` in ``dtype`` (None: its own; a tensor is
    copied to the host)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=dtype)


class Metric:
    """Minimal running metric protocol."""

    def __init__(self, sync_on_compute: bool = False) -> None:
        # accepted for config compatibility: the port logs from one process
        self.sync_on_compute = sync_on_compute

    def update(self, value: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def compute(self) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class MeanMetric(Metric):
    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        arr = _as_array(value).reshape(-1)
        self._total += float(arr.sum())
        self._count += arr.size

    def compute(self) -> float:
        return self._total / self._count if self._count else float("nan")

    def reset(self) -> None:
        self._total = 0.0
        self._count = 0


class SumMetric(Metric):
    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        self._total += float(_as_array(value).sum())

    def compute(self) -> float:
        return self._total

    def reset(self) -> None:
        self._total = 0.0


class MaxMetric(Metric):
    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        self._value = max(self._value, float(_as_array(value).max()))

    def compute(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = -np.inf


class MinMetric(Metric):
    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        self._value = min(self._value, float(_as_array(value).min()))

    def compute(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = np.inf


class LastValueMetric(Metric):
    """The last update; a many-element update keeps its mean."""

    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        arr = _as_array(value, dtype=None)  # a mean in the value's own precision, as the JAX package's
        self._value = float(arr.reshape(())) if arr.size == 1 else float(arr.mean())

    def compute(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = float("nan")


class CatMetric(Metric):
    """Concatenates updates; compute returns the flat float64 array."""

    def __init__(self, sync_on_compute: bool = False) -> None:
        super().__init__(sync_on_compute)
        self.reset()

    def update(self, value: Any) -> None:
        self._values.append(_as_array(value).reshape(-1))

    def compute(self) -> np.ndarray:
        return np.concatenate(self._values) if self._values else np.zeros((0,), dtype=np.float64)

    def reset(self) -> None:
        self._values = []


class MetricAggregatorException(Exception):
    """Raised on misuse of the MetricAggregator."""


class MetricAggregator:
    """Name -> :class:`Metric` table. The class-level ``disabled`` switch,
    set by ``run`` from ``metric.log_level``, turns every method into a
    no-op."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Metric]] = None, raise_on_missing: bool = False) -> None:
        self.metrics: Dict[str, Metric] = metrics if metrics is not None else {}
        self._raise_on_missing = raise_on_missing

    def add(self, name: str, metric: Metric) -> None:
        if self.disabled:
            return
        if name in self.metrics:
            raise MetricAggregatorException(f"Metric {name} already exists")
        self.metrics[name] = metric

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            if self._raise_on_missing:
                raise MetricAggregatorException(f"Metric {name} does not exist")
            return
        self.metrics[name].update(value)

    def pop(self, name: str) -> None:
        if self.disabled:
            return
        if name not in self.metrics and self._raise_on_missing:
            raise MetricAggregatorException(f"Metric {name} does not exist")
        self.metrics.pop(name, None)

    def reset(self) -> None:
        if self.disabled:
            return
        for metric in self.metrics.values():
            metric.reset()

    def compute(self) -> Dict[str, Any]:
        """Every metric's value, leaving out the empty ones (a NaN mean or
        last value, an empty concatenation)."""
        if self.disabled:
            return {}
        out: Dict[str, Any] = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, metric in self.metrics.items():
                value = metric.compute()
                if isinstance(value, float) and np.isnan(value):
                    continue
                if isinstance(value, np.ndarray) and value.size == 0:
                    continue
                out[name] = value
        return out

    def keys(self):
        return self.metrics.keys()

    def __contains__(self, name: str) -> bool:
        return name in self.metrics


class RankIndependentMetricAggregator:
    """A :class:`MetricAggregator` whose metrics never synchronise on
    ``compute`` (the decoupled loops' per-thread aggregation)."""

    def __init__(self, metrics: Dict[str, Metric]) -> None:
        self._aggregator = MetricAggregator(metrics)
        for m in self._aggregator.metrics.values():
            m.sync_on_compute = False

    @property
    def disabled(self) -> bool:
        return self._aggregator.disabled

    def update(self, name: str, value: Any) -> None:
        self._aggregator.update(name, value)

    def compute(self) -> Dict[str, Any]:
        return self._aggregator.compute()

    def reset(self) -> None:
        self._aggregator.reset()

    def keys(self):
        return self._aggregator.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._aggregator


_METRIC_CLASSES = {
    "MeanMetric": MeanMetric,
    "SumMetric": SumMetric,
    "MaxMetric": MaxMetric,
    "MinMetric": MinMetric,
    "LastValueMetric": LastValueMetric,
    "CatMetric": CatMetric,
}


def build_aggregator(
    metric_cfg: Dict[str, Any], keys_filter: Optional[set] = None, rank_independent: bool = False
) -> Union[MetricAggregator, RankIndependentMetricAggregator]:
    """An aggregator from the ``metric.aggregator`` block: each entry of
    ``metrics`` names its class by ``_target_`` (the last dotted component;
    ``MeanMetric`` when absent or unknown), its other keys are the class's
    arguments. ``rank_independent`` builds the sync-free variant."""
    metrics: Dict[str, Metric] = {}
    for name, spec in ((metric_cfg or {}).get("metrics") or {}).items():
        if keys_filter is not None and name not in keys_filter:
            continue
        target = spec.get("_target_", "MeanMetric") if isinstance(spec, dict) else "MeanMetric"
        cls = _METRIC_CLASSES.get(str(target).rsplit(".", 1)[-1], MeanMetric)
        kwargs = {k: v for k, v in spec.items() if k not in ("_target_", "sync_on_compute")} if isinstance(spec, dict) else {}
        metrics[name] = cls(**kwargs)
    if rank_independent:
        return RankIndependentMetricAggregator(metrics)
    return MetricAggregator(metrics, raise_on_missing=bool((metric_cfg or {}).get("raise_on_missing", False)))
