"""The port's Sebulba pipeline primitives (``sheeprl_tpu_torch/parallel/pipeline.py``)
on the CPU, against the JAX package's ``parallel/pipeline.py`` where the two
compute the same thing: ``staleness_bound`` equal over a grid, the queue's
behaviours of ``tests/test_utils/test_pipeline.py`` (back-pressure, the stop
flag, starvation, the staleness bound under a slow learner), the
``Fabric.partition`` rules on one device, and the chaos schedule's seeded draws (equal to
``sheeprl_tpu.fault.inject._parse_event``'s). Besides: the parameter
snapshots stay bit-equal to what was published while Adam updates the live
module in place, a snapshot is reused only when no actor holds it, the
queue admits blocked producers in arrival order, the stager's ring keeps
in-flight items intact, the launch counter is exact across threads, and a
``kill-thread`` point kills the thread with a ``BaseException``.

Every wait and join here carries its own limit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu.fault import inject as jax_inject
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.parallel.pipeline import staleness_bound as jax_staleness_bound
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.parallel import partition
from sheeprl_tpu_torch.parallel.pipeline import (
    DoubleBufferedStager,
    HandoffTimeoutError,
    ParamServer,
    PipelineStats,
    RolloutQueue,
    StagedItem,
    fold_seed,
    staleness_bound,
    supervised_actor_pool,
)

JOIN_S = 10.0


def _join(*threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), f"{t.name} did not end within {JOIN_S} s"


def _wait_for(cond, what):
    deadline = time.monotonic() + JOIN_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} did not happen within {JOIN_S} s"
        time.sleep(0.005)


@pytest.fixture(autouse=True)
def _clean_faults():
    inject.reset()
    yield
    inject.reset()


# -- staleness_bound ----------------------------------------------------------


@pytest.mark.parametrize("publish_every", [1, 2, 3, 4, 7])
def test_torch_pipeline_staleness_bound_equals_jax(publish_every):
    for depth in range(1, 6):
        for in_flight in range(1, 9):
            assert staleness_bound(depth, in_flight, publish_every) == jax_staleness_bound(depth, in_flight, publish_every)
    assert staleness_bound(2, 2, 1) == 5 and staleness_bound(2, 3, 2) == 3 and staleness_bound(1, 1, 4) == 1


# -- RolloutQueue -------------------------------------------------------------


def test_torch_pipeline_queue_backpressure_bounds_depth_under_slow_learner():
    stats = PipelineStats()
    q = RolloutQueue(depth=2, stats=stats)
    stop = threading.Event()
    produced = []

    def producer():
        for i in range(10):
            if not q.put(i, stop_event=stop):
                return
            produced.append(i)

    t = threading.Thread(target=producer, name="producer")
    t.start()
    consumed = []
    for _ in range(10):
        time.sleep(0.02)  # a slow learner
        consumed.append(q.get(timeout=5.0))
    _join(t)
    assert consumed == list(range(10))  # FIFO, nothing lost
    assert stats.max_depth_seen <= 2 and stats.actor_stall_s > 0.0
    assert stats.rollouts_produced == 10 and stats.rollouts_consumed == 10 and stats.rollouts_dropped == 0


def test_torch_pipeline_queue_put_unblocks_on_stop_and_beats():
    q = RolloutQueue(depth=1)
    stop = threading.Event()
    assert q.put("a", stop_event=stop)
    beats, result = [], {}

    def blocked_put():
        result["ok"] = q.put("b", stop_event=stop, beat=lambda: beats.append(1))

    t = threading.Thread(target=blocked_put, name="blocked")
    t.start()
    _wait_for(lambda: len(beats) >= 2, "two beats of the blocked producer")
    assert t.is_alive()  # blocked on the full queue, renewing its lease
    stop.set()
    _join(t)
    assert result["ok"] is False and q.stats.rollouts_dropped == 1  # dropped, not deadlocked
    assert q.drain() == ["a"] and q.qsize() == 0


def test_torch_pipeline_queue_get_records_starvation_and_deadline():
    stats = PipelineStats()
    q = RolloutQueue(depth=1, stats=stats)

    def late_put():
        time.sleep(0.05)
        q.put("x")

    t = threading.Thread(target=late_put, name="late")
    t.start()
    assert q.get(timeout=5.0) == "x"
    _join(t)
    assert stats.learner_starved_s > 0.0
    import queue as _queue

    with pytest.raises(_queue.Empty):
        q.get(timeout=0.05, deadline_s=10.0)
    with pytest.raises(HandoffTimeoutError, match="Producers: actor-0 hung"):
        for _ in range(40):
            try:
                q.get(timeout=0.05, deadline_s=0.2, diagnose=lambda: "actor-0 hung")
            except _queue.Empty:
                continue


def test_torch_pipeline_queue_admits_blocked_producers_in_arrival_order():
    """Three producers block on a full queue one after the other; each freed
    slot goes to the earliest of them (JAX's polled ``queue.Queue`` admits in
    no set order, so an actor could keep losing the slot)."""
    q = RolloutQueue(depth=1)
    stop = threading.Event()
    assert q.put("first", stop_event=stop)
    threads = []
    for i, name in enumerate(("a", "b", "c")):
        t = threading.Thread(target=q.put, args=(name,), kwargs={"stop_event": stop, "poll_s": 0.001}, name=name)
        t.start()
        threads.append(t)
        _wait_for(lambda: q._next_ticket == i + 2, f"{name}'s arrival")  # arrival order a, b, c
    got = [q.get(timeout=5.0) for _ in range(4)]
    _join(*threads)
    assert got == ["first", "a", "b", "c"]


def test_torch_pipeline_queue_stopped_ticket_does_not_block_the_next():
    q = RolloutQueue(depth=1)
    stop_a, stop_b = threading.Event(), threading.Event()
    assert q.put("first")
    results = {}
    ta = threading.Thread(target=lambda: results.update(a=q.put("a", stop_event=stop_a)), name="a")
    ta.start()
    _wait_for(lambda: q._next_ticket == 2, "a's arrival")
    tb = threading.Thread(target=lambda: results.update(b=q.put("b", stop_event=stop_b)), name="b")
    tb.start()
    _wait_for(lambda: q._next_ticket == 3, "b's arrival")
    stop_a.set()  # a gives up its turn before the slot frees
    _join(ta)
    assert q.get(timeout=5.0) == "first" and q.get(timeout=5.0) == "b"
    _join(tb)
    assert results == {"a": False, "b": True}


# -- ParamServer --------------------------------------------------------------


def _module(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 2))


def test_torch_pipeline_param_server_newest_wins_and_cadence():
    live = _module()
    ps = ParamServer(live, publish_every=2)
    assert ps.version == 0
    with pytest.raises(RuntimeError, match="before the first publish"):
        ps.pull()
    with torch.no_grad():
        live[0].weight.fill_(1.0)
    assert not ps.maybe_publish(1)  # update 1 of 2: no publish
    with torch.no_grad():
        live[0].weight.fill_(2.0)
    assert ps.maybe_publish(2)
    assert ps.version == 1
    v, snap = ps.pull()
    assert v == 1 and torch.equal(snap[0].weight, torch.full((8, 4), 2.0))  # newest wins
    assert snap is not live and not any(p.requires_grad for p in snap.parameters())
    ps.release(v)
    with pytest.raises(RuntimeError, match="not held"):
        ps.release(v)


def test_torch_pipeline_param_server_snapshot_isolated_from_in_place_adam():
    """The JAX package publishes a reference; here the live module is updated
    in place, so a published snapshot must be a copy: bit-equal to the
    parameters at publish time after 12 in-place Adam steps."""
    live = _module(1)
    opt = build_optimizer(live.parameters(), {"_target_": "adam", "lr": 1e-2, "eps": 1e-4, "weight_decay": 0,
                                               "betas": [0.9, 0.999]})
    ps = ParamServer(live)
    ps.publish()
    published = {k: v.clone() for k, v in live.state_dict().items()}
    version, snap = ps.pull()
    x = torch.randn(16, 4)
    for _ in range(12):
        loss = live(x).square().sum()
        opt.step(torch.autograd.grad(loss, list(live.parameters())))
    assert any(not torch.equal(live.state_dict()[k], v) for k, v in published.items())  # the live module moved
    for k, v in snap.state_dict().items():
        assert torch.equal(v, published[k]), k
    ps.release(version)


def test_torch_pipeline_param_server_reuses_only_unheld_snapshots():
    """A snapshot is rewritten only when it is neither the newest (an actor
    may pull it any time) nor held: with one actor holding v1, three
    snapshots serve any number of publishes."""
    live = _module(2)
    ps = ParamServer(live)
    ps.publish()  # v1
    v1, s1 = ps.pull()  # an actor holds v1
    ps.publish()  # v2: a second snapshot
    ps.publish()  # v3: v1 held, v2 the newest, so a third
    assert ps.snapshots == 3
    with torch.no_grad():
        live[0].bias.fill_(7.0)
    for _ in range(4):  # v4..v7 rotate through the two free ones
        ps.publish()
    assert ps.snapshots == 3 and not torch.equal(s1[0].bias, torch.full((8,), 7.0))
    ps.release(v1)
    ps.publish()  # v8: v1's snapshot is free again, and first in the pool
    assert ps.snapshots == 3 and torch.equal(s1[0].bias, torch.full((8,), 7.0))
    assert ps.pull()[0] == 8


def test_torch_pipeline_staleness_bound_holds_under_slow_learner():
    """One fast actor against a slow learner publishing every K updates: the
    version gap of every consumed item stays within staleness_bound()."""
    depth, K_ = 2, 2
    bound = staleness_bound(depth, 1, K_)
    live = _module(3)
    stats = PipelineStats()
    q = RolloutQueue(depth, stats=stats)
    ps = ParamServer(live, publish_every=K_, stats=stats)
    ps.publish()
    stop = threading.Event()

    def actor():
        while not stop.is_set():
            v, _ = ps.pull()
            ps.release(v)
            if not q.put({"version": v}, stop_event=stop):
                return

    t = threading.Thread(target=actor, name="actor")
    t.start()
    worst = 0
    for update in range(1, 40):
        item = q.get(timeout=5.0)
        time.sleep(0.005)  # a slow learner
        ps.maybe_publish(update)
        stats.observe_staleness(ps.version - item["version"])
        worst = max(worst, ps.version - item["version"])
    stop.set()
    q.drain()
    _join(t)
    assert 0 < worst <= bound, (worst, bound)
    assert stats.max_staleness_seen == worst and sum(stats.staleness_hist.values()) == 39


# -- DoubleBufferedStager -------------------------------------------------------


def test_torch_pipeline_stager_slab_is_one_blob_of_its_keys():
    """An acquired slab is a view per key into one byte buffer (one upload
    carries every key), in the template's shapes and dtypes; on the CPU the
    uploaded item aliases it and has no event."""
    stager = DoubleBufferedStager("cpu", slots=3)
    slab = stager.acquire({"a": ((8,), np.float32), "b": ((8, 2), np.float32), "d": ((8, 1), np.uint8)})
    slab["a"][:] = np.arange(8, dtype=np.float32)
    slab["b"][:] = 1.0
    slab["d"][:] = 3
    assert slab.blob.numel() == slab.layout.nbytes and not slab.blob.is_pinned()
    item = StagedItem.record(stager.upload(slab))
    data = item.wait()
    assert item.event is None  # the CPU has no streams
    assert data["a"].dtype == torch.float32 and data["d"].dtype == torch.uint8 and data["b"].shape == (8, 2)
    np.testing.assert_array_equal(data["a"].numpy(), np.arange(8, dtype=np.float32))
    assert data["a"].untyped_storage().data_ptr() == slab.blob.untyped_storage().data_ptr()


def test_torch_pipeline_stager_ring_keeps_in_flight_items_intact():
    """On the CPU an upload aliases its slab (the JAX CPU backend's zero-copy
    device_put): the ring keeps ``slots`` in-flight items intact, and the
    slot after them is the first slab again."""
    slots = 4
    stager = DoubleBufferedStager("cpu", slots=slots)
    template = {"x": ((3, 2), np.float32), "d": ((3, 1), np.uint8)}
    held = []
    for i in range(slots):
        slab = stager.acquire(template)
        slab["x"][:] = float(i)
        slab["d"][:] = i
        held.append(StagedItem.record(stager.upload(slab)))
    for i, item in enumerate(held):
        data = item.wait()
        assert torch.equal(data["x"], torch.full((3, 2), float(i))) and torch.equal(data["d"], torch.full((3, 1), i, dtype=torch.uint8))
    again = stager.acquire(template)
    again["x"][:] = 99.0
    assert float(held[0].wait()["x"][0, 0]) == 99.0  # the ring came round: slot 0 is the caller's again
    with pytest.raises(ValueError, match="one layout"):
        stager.acquire({"x": ((4,), np.float32)})
    with pytest.raises(ValueError, match="at least 2"):
        DoubleBufferedStager("cpu", slots=1)


# -- partition --------------------------------------------------------------------


@pytest.mark.parametrize("actor_devices", ["auto", 0, 1, 2, -1])
def test_torch_pipeline_partition_follows_the_jax_rules(actor_devices):
    """JAX's Fabric.partition on one device: the port raises JAX's
    ValueError exactly where JAX does, and where JAX time-slices returns the
    one device twice."""
    fabric = Fabric(devices=1, accelerator="cpu")
    try:
        actor, learner = fabric.partition(actor_devices)
    except ValueError:
        with pytest.raises(ValueError, match="learner device"):
            partition("cpu", actor_devices)
        return
    assert actor.devices[0] is learner.devices[0]  # JAX time-slices one device
    assert partition("cpu", actor_devices) == (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError, match="int or 'auto'"):
        partition("cpu", "half")


# -- supervision, chaos and counting -----------------------------------------------------


def test_torch_pipeline_supervised_pool_deadline_widens_until_the_first_item():
    stats = PipelineStats()
    sup, deadline = supervised_actor_pool({"handoff_deadline_s": 5.0, "grace_s": 30.0}, "pool", stats)
    assert deadline() == 35.0
    stats.add("rollouts_consumed", 1)
    assert deadline() == 5.0
    _, none = supervised_actor_pool({"handoff_deadline_s": None}, "pool", stats)
    assert none() is None
    sup.join(budget_s=1.0)


@pytest.mark.parametrize("token", ["sac_sebulba.actor1.step:raise:8-16", "ppo_sebulba.actor0.step:kill-thread:3-30",
                                   "pipeline.queue.put:hang:2:0.5", "x:raise"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_torch_pipeline_chaos_schedule_draws_equal_jax(token, seed):
    assert inject._parse_event(token, seed=seed) == jax_inject._parse_event(token, seed=seed)


def test_torch_pipeline_arm_from_cfg_and_kill_thread():
    cfg = {"fault": {"chaos": {"enabled": True, "seed": 3, "events": ["t.point:kill-thread:2"]}}}
    assert inject.arm_from_cfg(cfg) == 1
    assert inject.arm_from_cfg({"fault": {"chaos": {"enabled": False, "events": ["t.other:raise:1"]}}}) == 0
    seen = {}

    def worker():
        try:
            inject.fault_point("t.point")  # hit 1: nothing
            inject.fault_point("t.point")  # hit 2: the thread dies
        except BaseException as e:  # noqa: BLE001 - what the supervisor sees
            seen["error"] = e

    t = threading.Thread(target=worker, name="victim")
    t.start()
    _join(t)
    assert isinstance(seen["error"], inject.ThreadKilled) and not isinstance(seen["error"], Exception)


def test_torch_pipeline_launch_counter_exact_across_threads():
    K.reset_launches()
    n_threads, per_thread = 8, 2000
    barrier = threading.Barrier(n_threads, timeout=JOIN_S)

    def work():
        barrier.wait()
        for _ in range(per_thread):
            K.count_launch("gae")

    threads = [threading.Thread(target=work, name=f"w{i}") for i in range(n_threads)]
    for t in threads:
        t.start()
    _join(*threads)
    assert K.LAUNCHES["gae"] == n_threads * per_thread
    K.reset_launches()


def test_torch_pipeline_fold_seed_is_a_pure_function_of_state_and_ids():
    base = torch.Generator().manual_seed(44)
    state = base.get_state()
    seeds = {fold_seed(state, a, g) for a in range(3) for g in range(3)}
    assert len(seeds) == 9  # every (actor, generation) its own stream
    assert fold_seed(state, 1, 2) == fold_seed(base.get_state(), 1, 2)  # the base generator did not move
    assert fold_seed(torch.Generator().manual_seed(45).get_state(), 1, 2) != fold_seed(state, 1, 2)
