"""The port's metrics and aggregators against the JAX package's
(``sheeprl_tpu/utils/metric.py``): the same seeded numpy streams, fed as
Python numbers, numpy arrays and torch tensors, give exactly the same
values (tolerance 0: both accumulate in float64 in the same order), and the
aggregators behave alike on every method, including the misuse errors."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.utils import metric as jm
from sheeprl_tpu_torch.utils import metric as tm

KINDS = ["MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "LastValueMetric", "CatMetric"]


@pytest.fixture(autouse=True)
def _enabled(monkeypatch):
    """A run earlier in the process may have left the class-level switch off."""
    for mod in (tm, jm):
        monkeypatch.setattr(mod.MetricAggregator, "disabled", False)


def _stream(seed: int):
    """Scalars, 0-d arrays, vectors and matrices of float32 and float64."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        shape = [(), (1,), (3,), (2, 4)][i % 4]
        dtype = np.float32 if i % 3 else np.float64
        out.append(np.asarray((rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4)).astype(dtype)))
    return out


def _as(kind: str, value: np.ndarray):
    if kind == "number":
        return float(value.reshape(-1)[0]) if value.size == 1 else value
    if kind == "tensor":
        return torch.from_numpy(np.asarray(value))
    return value


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("feed", ["numpy", "number", "tensor"])
@pytest.mark.parametrize("kind", KINDS)
def test_torch_metric_streams_equal_jax(kind, feed):
    ours, theirs = getattr(tm, kind)(), getattr(jm, kind)()
    _same(ours.compute(), theirs.compute())  # the empty state
    for i, value in enumerate(_stream(seed=KINDS.index(kind))):
        ours.update(_as(feed, value))
        theirs.update(value)
        if i % 7 == 0:
            _same(ours.compute(), theirs.compute())
    _same(ours.compute(), theirs.compute())
    ours.reset()
    theirs.reset()
    _same(ours.compute(), theirs.compute())
    ours.update(_as(feed, np.float32(2.5)))
    theirs.update(np.float32(2.5))
    _same(ours.compute(), theirs.compute())


def _config():
    return {
        "raise_on_missing": False,
        "metrics": {
            "Rewards/rew_avg": {"_target_": "MeanMetric", "sync_on_compute": False},
            "Game/ep_len_avg": {"_target_": "torchmetrics.MeanMetric"},
            "Loss/value_loss": {"_target_": "sheeprl_tpu.utils.metric.SumMetric"},
            "State/kl": {"_target_": "MaxMetric"},
            "State/min": {"_target_": "MinMetric"},
            "Info/last": {"_target_": "LastValueMetric"},
            "Info/all": {"_target_": "CatMetric"},
            "Info/unknown": {"_target_": "NoSuchMetric"},
        },
    }


@pytest.mark.parametrize("keys_filter", [None, {"Rewards/rew_avg", "State/kl", "Info/all"}], ids=["all", "filtered"])
def test_torch_metric_aggregator_from_config_equals_jax(keys_filter):
    ours, theirs = tm.build_aggregator(_config(), keys_filter), jm.build_aggregator(_config(), keys_filter)
    assert list(ours.keys()) == list(theirs.keys())
    assert [type(m).__name__ for m in ours.metrics.values()] == [type(m).__name__ for m in theirs.metrics.values()]
    assert ours.compute() == theirs.compute()  # every metric at its start (max -inf, sum 0, ...)
    rng = np.random.default_rng(3)
    for step in range(30):
        name = list(_config()["metrics"])[step % 8]
        value = rng.standard_normal(int(rng.integers(1, 4))).astype(np.float32)
        ours.update(name, torch.from_numpy(value) if step % 2 else value)
        theirs.update(name, value)
        if step % 10 == 9:
            a, b = ours.compute(), theirs.compute()
            assert list(a) == list(b)
            for k in a:
                _same(a[k], b[k])
            ours.reset()
            theirs.reset()
    ours.pop("State/kl")
    theirs.pop("State/kl")
    assert ("State/kl" in ours) == ("State/kl" in theirs) is False


def test_torch_metric_aggregator_surface_equals_jax():
    for mod in (tm, jm):
        agg = mod.MetricAggregator({"a": mod.MeanMetric()}, raise_on_missing=True)
        agg.add("b", mod.SumMetric())
        with pytest.raises(mod.MetricAggregatorException, match="Metric b already exists"):
            agg.add("b", mod.SumMetric())
        with pytest.raises(mod.MetricAggregatorException, match="Metric c does not exist"):
            agg.update("c", 1.0)
        with pytest.raises(mod.MetricAggregatorException, match="Metric c does not exist"):
            agg.pop("c")
        quiet = mod.MetricAggregator({"a": mod.MeanMetric()})
        quiet.update("c", 1.0)
        quiet.pop("c")  # no error without raise_on_missing
        agg.update("a", 2.0)
        agg.update("b", 3.0)
        assert agg.compute() == {"a": 2.0, "b": 3.0} and sorted(agg.keys()) == ["a", "b"] and "a" in agg
        independent = mod.RankIndependentMetricAggregator({"x": mod.MeanMetric(sync_on_compute=True)})
        assert all(m.sync_on_compute is False for m in independent._aggregator.metrics.values())
        independent.update("x", 4.0)
        assert independent.compute() == {"x": 4.0} and list(independent.keys()) == ["x"] and "x" in independent
        independent.reset()
        assert independent.compute() == {}
        assert isinstance(mod.build_aggregator(_config(), rank_independent=True), mod.RankIndependentMetricAggregator)


def test_torch_metric_disabled_aggregator_is_a_no_op_like_jax(monkeypatch):
    for mod in (tm, jm):
        monkeypatch.setattr(mod.MetricAggregator, "disabled", True)
        agg = mod.MetricAggregator({"a": mod.MeanMetric()}, raise_on_missing=True)
        agg.update("missing", 1.0)  # no raise while disabled
        agg.add("a", mod.MeanMetric())
        agg.update("a", 1.0)
        assert agg.compute() == {} and agg.metrics["a"].compute() != agg.metrics["a"].compute()  # NaN: never updated
        assert mod.RankIndependentMetricAggregator({}).disabled


def test_torch_metric_tensor_update_reads_the_value_once():
    """A 0-dim tensor and a many-element one update like their numpy
    values; the update copies to the host in float64."""
    m = tm.MeanMetric()
    m.update(torch.tensor(1.0, dtype=torch.float32))
    m.update(torch.tensor([2.0, 3.0], dtype=torch.float64))
    assert m.compute() == 2.0
    cat = tm.CatMetric()
    cat.update(torch.arange(3, dtype=torch.float32))
    assert cat.compute().dtype == np.float64 and cat.compute().tolist() == [0.0, 1.0, 2.0]
