"""The port's fleet router over IN-PROCESS replica servers on the CPU (real
sockets, the real protocol, no subprocesses): the drills of the JAX
package's ``tests/test_serve/test_fleet.py`` (least-loaded spread, the
non-decreasing ``fleet_version``, session stickiness and the counted,
visible re-home, the failover retry, fleet-wide shedding, the replica
endpoint's timeout against a hung server, the client's typed timeout, the
drain), ``replica_command`` against JAX's argv (only the module differs),
a small DreamerV3 served through the router answering as one server does,
and the fault the slice repairs: ``serve.fleet.replicas=3`` serves a fleet.
The process lifecycle (SIGKILL, SIGSTOP, respawn under load) is in
``test_torch_fleet_chaos.py``. No assertion rests on a sub-second lease or
on an exact spread."""

import collections
import socket
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import apply_overrides, dotdict, preset
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.serve import fleet as fleet_mod
from sheeprl_tpu_torch.serve.fleet import FleetReplicaError, FleetRouter, ReplicaEndpoint, replica_command
from sheeprl_tpu_torch.serve.scheduler import ServeTimeoutError
from sheeprl_tpu_torch.serve.server import PolicyServer
from tests.torch_fleet_replica_main import build_policy

X = {"obs": {"x": [[1.0, 2.0]]}, "n": 1}


@pytest.fixture(autouse=True)
def _isolation():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inject.reset()
    yield
    inject.reset()
    torch.set_num_threads(n)


def _wait(predicate, timeout=15.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


def _stand_up(policy, n=2, server_cfg=None, **router_cfg):
    servers, endpoints = [], []
    for i in range(n):
        cfg = {"buckets": [1, 4], "port": 0, "max_wait_ms": 1.0, **(server_cfg or {})}
        server = PolicyServer(policy, cfg).start()
        servers.append(server)
        endpoints.append(ReplicaEndpoint(f"replica-{i}", *server.address, request_timeout_s=10.0))
    router = FleetRouter(endpoints, fleet_cfg={"health_poll_s": 0.05, "health_timeout_s": 2.0, "retry_budget": 2,
                                               **router_cfg}, port=None).start()
    assert router.wait_ready(timeout_s=30)
    return router, servers, endpoints


def _teardown(router, servers):
    router.stop()
    for s in servers:
        s.stop()


def test_torch_fleet_least_loaded_routing_spreads_and_annotates():
    router, servers, _ = _stand_up(build_policy(False))
    try:
        used, last = collections.Counter(), -10
        for i in range(12):
            resp = router.serve_request({"obs": {"x": [[1.0, float(i)]]}, "n": 1})
            assert "error" not in resp, resp
            np.testing.assert_allclose(resp["actions"], [[3.0 * i, 1.0 + 4.0 * i, 2.0 + 5.0 * i]])
            used[resp["replica"]] += 1
            assert resp["fleet_version"] >= last
            last = resp["fleet_version"]
        assert set(used) == {"replica-0", "replica-1"}  # spread, not pinned
        assert router.counters["routed"] == 12
    finally:
        _teardown(router, servers)


def test_torch_fleet_aggregated_health_reflects_fleet_state():
    router, servers, _ = _stand_up(build_policy(False))
    try:
        health = router.health()
        assert health["status"] == "ok" and health["ready"] is True
        assert health["fleet"]["replicas"] == 2 and health["fleet"]["ready"] == 2
        for entry in health["replicas"].values():
            assert entry["ready"] is True and entry["status"] == "ok" and "step" in entry
        servers[0].stop()
        assert _wait(lambda: router.health()["status"] == "degraded")
        servers[1].stop()
        assert _wait(lambda: router.health()["status"] == "down")
        assert router.health()["ready"] is False
    finally:
        router.stop()


def _stateful_fleet(n=2):
    policy = build_policy(True)
    return _stand_up(policy, n, server_cfg={"session": {"buckets": [1, 4], "max_sessions": 32}})


def test_torch_fleet_sessions_stick_to_one_replica():
    router, servers, _ = _stateful_fleet()
    try:
        homes = set()
        for step in range(6):
            resp = router.serve_request({**X, "session_id": "user-a"})
            assert resp["actions"][0][0] == float(step)  # one contiguous stream
            homes.add(resp["replica"])
            router.serve_request(X)  # stateless traffic in between
        assert len(homes) == 1
    finally:
        _teardown(router, servers)


def test_torch_fleet_session_rehome_on_replica_death_is_counted_and_visible():
    router, servers, eps = _stateful_fleet()
    victim = None
    try:
        for step in range(3):
            resp = router.serve_request({**X, "session_id": "user-a"})
            assert resp["actions"][0][0] == float(step)
        home = resp["replica"]
        victim = next(s for s, ep in zip(servers, eps) if ep.name == home)
        victim.stop()
        assert _wait(lambda: not next(ep for ep in eps if ep.name == home).ready)
        resp = router.serve_request({**X, "session_id": "user-a"})
        assert "error" not in resp, resp
        assert resp["replica"] != home and resp.get("rehomed") is True
        assert resp["actions"][0][0] == 0.0  # a visible re-init, never silent state
        assert router.counters["sessions_rehomed"] == 1
        resp = router.serve_request({**X, "session_id": "user-a"})
        assert resp["actions"][0][0] == 1.0 and "rehomed" not in resp
        assert router.counters["sessions_rehomed"] == 1
    finally:
        router.stop()
        for s in servers:
            if s is not victim:
                s.stop()


def test_torch_fleet_midflight_failover_retries_within_budget():
    router, servers, eps = _stand_up(build_policy(False), health_poll_s=30.0)  # one tick, then a frozen view
    try:
        servers[0].stop()
        with router._lock:
            eps[0].ready = True  # the router still believes in it
            eps[1].inflight = 1  # so least-loaded picks the dead one first
        resp = router.serve_request(X)
        with router._lock:
            eps[1].inflight = 0
        assert "error" not in resp, resp
        assert resp["replica"] == "replica-1"
        assert router.counters["retries"] >= 1 and router.counters["replica_errors"] >= 1
    finally:
        router.stop()
        servers[1].stop()


def test_torch_fleet_wide_shed_propagates_overload_error():
    router, servers, _ = _stand_up(build_policy(False))
    try:
        for s in servers:
            s.stop()
        assert _wait(lambda: router.health()["status"] == "down")
        resp = router.serve_request(X)
        assert "ServeOverloadedError" in resp["error"] and router.counters["shed"] == 1
    finally:
        router.stop()


def test_torch_fleet_max_inflight_sheds_instead_of_queueing():
    router, servers, eps = _stand_up(build_policy(False), max_inflight=1)
    try:
        with router._lock:
            for ep in eps:
                ep.inflight = 1
        resp = router.serve_request(X)
        assert "ServeOverloadedError" in resp["error"] and router.counters["shed"] == 1
    finally:
        with router._lock:
            for ep in eps:
                ep.inflight = 0
        _teardown(router, servers)


def test_torch_fleet_free_port_is_below_the_ephemeral_range():
    """A replica binds its port seconds after the pick (and again at each
    respawn): the pick avoids the range the kernel hands to outgoing
    connections, which could take it first."""
    low = fleet_mod._ephemeral_low()
    ports = {fleet_mod.free_port() for _ in range(8)}
    assert all(1024 <= p < low for p in ports)
    for p in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


def test_torch_fleet_replica_endpoint_times_out_against_hung_server():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    try:
        ep = ReplicaEndpoint("hung", "127.0.0.1", listener.getsockname()[1], request_timeout_s=0.3)
        start = time.monotonic()
        with pytest.raises(FleetReplicaError, match="no response within") as excinfo:
            ep.request(X)
        assert excinfo.value.timed_out is True and time.monotonic() - start < 5.0
        ep.close()
    finally:
        listener.close()


def test_torch_fleet_policy_client_timeout_is_typed_and_bounded():
    server = PolicyServer(build_policy(False), {"buckets": [1, 4], "port": None, "client_timeout_s": 0.3}).start()
    try:
        assert server.client.timeout_s == 0.3
        inject.arm("serve.scheduler.batch", action="hang", at=1, hang_s=5.0)
        start = time.monotonic()
        with pytest.raises(ServeTimeoutError):
            server.client.act({"x": np.ones((1, 2), np.float32)}, n=1)
        assert time.monotonic() - start < 3.0
        inject.release_hangs()
    finally:
        inject.reset()
        server.stop()


def test_torch_fleet_router_drain_rejects_new_requests_and_probe_carries_the_queue():
    router, servers, eps = _stand_up(build_policy(False))
    try:
        probe = eps[0].probe(2.0)
        assert probe["scheduler"]["queue_depth"] == 0 and "launches" in probe["engine"]
        assert probe["weights"]["step"] == 0
        router._draining = True
        assert "ServeClosedError" in router.serve_request(X)["error"]
    finally:
        router._draining = False
        _teardown(router, servers)


@pytest.mark.parametrize("cfg", [
    {"serve": {}, "fabric": {}},
    {"serve": {"mode": "sample", "max_wait_ms": 2.0, "buckets": [1, 8], "watch_poll_s": 0.5, "queue_bound": 64},
     "fabric": {"accelerator": "cpu"}, "seed": 7},
    {"serve": {"flywheel": {"enabled": True, "dir": "/tmp/fly", "block_rows": 64, "flush_s": 0.1}},
     "fabric": {"accelerator": "cuda"}},
], ids=["bare", "knobs", "flywheel"])
def test_torch_fleet_replica_command_matches_jax(cfg):
    from sheeprl_tpu.config import dotdict as jax_dotdict
    from sheeprl_tpu.serve.fleet import replica_command as jax_replica_command

    want = jax_replica_command(jax_dotdict(cfg), "/ckpt/ckpt_2_0.ckpt", "127.0.0.1", 1234, name="replica-1")
    got = replica_command(dotdict(cfg), "/ckpt/ckpt_2_0.ckpt", "127.0.0.1", 1234, name="replica-1")
    assert want[:3] == [got[0], "-m", "sheeprl_tpu"] and got[:3] == [want[0], "-m", "sheeprl_tpu_torch"]
    assert got[3:] == want[3:]


# -- a small DreamerV3 served through the router --------------------------------------
RSSM_TINY = [
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.recurrent_model.dense_units=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.actor.dense_units=8",
    "algo.actor.mlp_layers=1",
]


def test_torch_fleet_rssm_sessions_match_single_server():
    """Four DreamerV3 sessions (a tiny-width preset from a seed) stepped
    through a router over two replica servers answer exactly as through one
    server; each session stays on its replica and its launches count once
    per dispatch on the CPU's plain path (no kernel launches here)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import serve_policy_dreamer_v3

    policy = serve_policy_dreamer_v3(apply_overrides(preset("dreamer_v3_S_atari100k"), RSSM_TINY), None, "cpu")
    rng = np.random.default_rng(0)
    frames = [[rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8).tolist() for _ in range(5)] for _ in range(4)]
    scfg = {"session": {"buckets": [1, 4], "max_sessions": 16}}

    def traffic(ask):
        out = [[None] * 5 for _ in range(4)]
        for t in range(5):
            for s in range(4):
                msg = {"obs": {"rgb": frames[s][t]}, "session_id": f"s{s}", "reset": s == 1 and t == 3}
                out[s][t] = ask(msg)
        return out

    single = PolicyServer(policy, {"port": None, "max_wait_ms": 1.0, **scfg}).start()
    try:
        def ask_single(msg):
            actions, _ = single.client.act({"rgb": np.asarray(msg["obs"]["rgb"], np.uint8)[None]},
                                           session_id=msg["session_id"], reset=msg["reset"])
            return np.asarray(actions).tolist()
        want = traffic(ask_single)
    finally:
        single.stop()
    router, servers, _ = _stand_up(policy, 2, server_cfg=scfg)
    try:
        homes = collections.defaultdict(set)

        def ask_fleet(msg):
            resp = router.serve_request(msg)
            assert "error" not in resp, resp
            homes[msg["session_id"]].add(resp["replica"])
            return resp["actions"]
        got = traffic(ask_fleet)
        dispatches = sum(s.engine.stats()["dispatches"] for s in servers)
    finally:
        _teardown(router, servers)
    assert got == want
    assert all(len(h) == 1 for h in homes.values()) and router.counters["sessions_rehomed"] == 0
    assert dispatches == 20


# -- the fault this slice repairs: serve.fleet.replicas was taken and ignored ---------
@pytest.fixture
def sac_ckpt(tmp_path):
    from tests.test_torch_flywheel import sac_checkpoint

    return sac_checkpoint(tmp_path)


def test_torch_fleet_serve_replicas_key_serves_a_fleet(sac_ckpt, monkeypatch):
    seen = []
    monkeypatch.setattr(fleet_mod, "serve_fleet", lambda cfg: seen.append(cfg) or {"fleet": True})
    cli.main(["serve", f"checkpoint_path={sac_ckpt}", "fabric.accelerator=cpu", "serve.fleet.replicas=3",
              "serve.max_requests=0", "serve.port=0"])
    assert len(seen) == 1 and seen[0].serve.fleet.replicas == 3
    assert seen[0].algo.name == "sac" and seen[0].checkpoint_path == str(sac_ckpt)


@pytest.mark.parametrize("argv, replicas", [
    (["serve_fleet"], 3),
    (["serve_fleet", "serve.fleet.replicas=4"], 4),
    (["serve", "--fleet"], 3),
    (["serve", "--fleet", "2"], 2),
    (["serve", "--fleet=5"], 5),
], ids=["verb", "verb_key", "flag_bare", "flag_count", "flag_equals"])
def test_torch_fleet_verb_and_flag_dispatch_to_the_fleet(sac_ckpt, monkeypatch, argv, replicas):
    seen = []
    monkeypatch.setattr(fleet_mod, "serve_fleet", lambda cfg: seen.append(cfg))
    cli.main(argv + [f"checkpoint_path={sac_ckpt}", "fabric.accelerator=cpu"])
    assert [c.serve.fleet.replicas for c in seen] == [replicas]


@pytest.mark.parametrize("argv", [["serve_fleet", "serve.fleet.replicas=1"], ["serve", "--fleet", "1"]],
                         ids=["verb", "flag"])
def test_torch_fleet_asked_for_with_one_replica_raises(sac_ckpt, argv):
    with pytest.raises(ValueError, match="serve.fleet.replicas >= 2"):
        cli.main(argv + [f"checkpoint_path={sac_ckpt}", "fabric.accelerator=cpu"])


def test_torch_fleet_serve_config_takes_the_jax_defaults():
    from sheeprl_tpu.config import compose

    from sheeprl_tpu_torch.config import SERVE_DEFAULTS

    jax_serve = compose([], config_name="serve_config").serve
    for block in ("fleet", "flywheel"):
        want = {k: (dict(v) if isinstance(v, dict) else v) for k, v in dict(jax_serve[block]).items()}
        assert SERVE_DEFAULTS["serve"][block] == want, block
    assert SERVE_DEFAULTS["serve"]["client_timeout_s"] == jax_serve["client_timeout_s"]


def test_torch_fleet_router_without_card_refuses_to_start(sac_ckpt, monkeypatch):
    """No card and no ``fabric.accelerator=cpu``: the fleet raises before any
    replica starts; a replica never serves from the CPU for want of a card."""
    seen = []
    monkeypatch.setattr(fleet_mod, "serve_fleet", lambda cfg: seen.append(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve_fleet", f"checkpoint_path={sac_ckpt}"])
    assert seen == []
