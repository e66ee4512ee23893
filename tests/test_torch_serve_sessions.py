"""The port's session-serving tier on the CPU, over a real socket: session
open, reset and eviction counters, bucket padding through the donor row,
batched-equals-alone per session, hot swaps, and the ``serve`` entry point.
A tiny DreamerV3 (pixels, 2-wide CNN) from a seed; no JAX anywhere."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import serve_policy_dreamer_v3
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.serve.server import PolicyServer, request_over_socket
from sheeprl_tpu_torch.serve.sessions import SessionEngine
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint, save_checkpoint

TINY = [
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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several pytest workers side by side: torch's default of
    # one thread per core each would oversubscribe the machine and slow the
    # timing-sensitive tests of the other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(extra=()):
    return apply_overrides(preset("dreamer_v3_S_atari100k"), TINY + list(extra))


def _policy(extra=()):
    return serve_policy_dreamer_v3(_cfg(extra), None, "cpu")


def _frames(seed, T):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(1, 64, 64, 3), dtype=np.uint8) for _ in range(T)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torch_serve_sessions_socket_lifecycle():
    policy = _policy()
    cfg = {"port": 0, "max_wait_ms": 1.0, "session": {"buckets": [1, 4], "max_sessions": 3}}
    with PolicyServer(policy, cfg) as server:
        addr = server.address
        frame = _frames(0, 1)[0][0].tolist()

        def step(sid, reset=False):
            resp = request_over_socket(addr, {"obs": {"rgb": frame}, "session_id": sid, "reset": reset})
            assert "actions" in resp, resp
            (action,) = resp["actions"]
            assert len(action) == 1 and 0 <= action[0] < 9
            return resp

        for sid in ("a", "b", "c"):
            step(sid)
        step("a", reset=True)
        h = request_over_socket(addr, {"health": True})
        assert h["status"] == "ok" and h["ready"] and h["engine"]["device"] == "cpu"
        assert h["sessions"]["live"] == 3 and h["sessions"]["opened"] == 3
        assert h["sessions"]["client_resets"] == 1 and h["sessions"]["evictions"] == 0
        step("d")  # the cache holds 3: the least recently used ("b") goes
        h = request_over_socket(addr, {"health": True})
        assert h["sessions"]["live"] == 3 and h["sessions"]["evictions"] == 1 and h["sessions"]["peak"] == 3
        assert "b" not in server.engine.cache._sessions

        # one-shot rows (no session): 3 rows padded into bucket 4 on the donor row
        before = server.engine.stats()
        rgb = np.concatenate(_frames(1, 3), axis=0).tolist()
        resp = request_over_socket(addr, {"obs": {"rgb": rgb}, "n": 3})
        assert np.asarray(resp["actions"]).shape == (3, 1)
        after = server.engine.stats()
        assert after["dispatches"] == before["dispatches"] + 1
        assert after["padded_rows"] == before["padded_rows"] + 1
        bad = request_over_socket(addr, {"obs": {"rgb": [[0]]}, "session_id": "e"})
        assert "error" in bad
        assert h["engine"]["warmup_dispatches"] == 2


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_torch_serve_sessions_batched_equals_alone(mode):
    """Row i of a padded, batched step equals stepping that session alone:
    its random draws depend on its own seed and step count only, and no
    padding or neighbour row leaks into it."""
    policy = _policy()
    engine = SessionEngine(policy, buckets=(1, 4), mode=mode, max_sessions=8)
    params = policy.params
    T = 5
    solo_frames = _frames(3, T)
    others = [_frames(10 + i, T) for i in range(2)]
    alone = [engine.step_sessions(params, policy.prepare({"rgb": f}, 1), ["solo"])[0] for f in solo_frames]
    batched = []
    for t in range(T):
        rgb = np.concatenate([others[0][t], solo_frames[t], others[1][t]], axis=0)
        out = engine.step_sessions(params, policy.prepare({"rgb": rgb}, 3), ["x", "twin", "y"])
        batched.append(out[1])
    np.testing.assert_array_equal(np.stack(batched), np.stack(alone))
    slab = engine.cache.slab
    solo, twin = (engine.cache._sessions[s].row for s in ("solo", "twin"))
    # matrix products at batch 1 and batch 4 may round differently in the
    # last bit, so the float state agrees to float32 rounding (atol 1e-6)
    for k in ("recurrent", "stochastic", "actions"):
        torch.testing.assert_close(slab[k][twin], slab[k][solo], atol=1e-6, rtol=1e-6)
    assert torch.equal(slab["counter"][twin], slab["counter"][solo])
    assert int(slab["counter"][engine.cache._sessions["twin"].row]) == T
    # the 3-row steps were padded to bucket 4 through the donor row; rows no
    # session ever claimed stay untouched
    assert engine.stats()["padded_rows"] == T
    claimed = {s.row for s in engine.cache._sessions.values()} | {engine.cache.donor_row}
    for r in set(range(engine.cache.max_sessions + 1)) - claimed:
        assert float(slab["recurrent"][r].abs().sum()) == 0.0


def test_torch_serve_sessions_hot_swap():
    policy = _policy()
    with PolicyServer(policy, {"max_wait_ms": 1.0, "session": {"buckets": [1]}}) as server:
        frame = policy.prepare({"rgb": _frames(4, 1)[0]}, 1)
        server.client.act({"rgb": _frames(4, 1)[0]}, session_id="s")
        perturbed = {
            k: {n: t + 1e-3 for n, t in sd.items()}
            for k, sd in (("world_model", policy.params.world_model.state_dict()), ("actor", policy.params.actor.state_dict()))
        }
        assert server.weights.publish_state(perturbed) == 1
        _, version = server.client.act({"rgb": _frames(4, 1)[0]}, session_id="s")
        assert version == 1 and server.engine.cache.snapshot()["resets"] == 0
        # params whose per-row state no longer fits: sessions re-init, counted
        other = serve_policy_dreamer_v3(_cfg(["algo.world_model.recurrent_model.recurrent_state_size=12"]), None, "cpu")
        assert not server.engine.check_swap(other.params)
        server.engine.cache.touch("s")
        assert server.engine.cache.snapshot()["resets"] == 1
        assert frame["rgb"].shape == (1, 64, 64, 3)


def test_torch_serve_cli_entry_point(tmp_path):
    """``python -m sheeprl_tpu_torch serve`` as a user runs it (in a thread,
    on the CPU): checkpoint + config.json in, actions over the socket out."""
    cfg = _cfg()
    policy = serve_policy_dreamer_v3(cfg, None, "cpu")
    state = {"world_model": policy.params.world_model.state_dict(), "actor": policy.params.actor.state_dict()}
    ckpt = save_checkpoint(tmp_path / "run" / "ckpt_0.pt", state, plain(cfg))
    assert find_run_config(ckpt) == tmp_path / "run" / "config.json"
    loaded = load_checkpoint(ckpt)
    assert torch.equal(loaded["actor"]["head_0.weight"], state["actor"]["head_0.weight"])

    port = _free_port()
    args = [
        f"checkpoint_path={ckpt}",
        "fabric.accelerator=cpu",
        f"serve.port={port}",
        "serve.session.buckets=[1,2]",
        "serve.max_requests=4",
        "serve.max_wait_ms=1",
    ]
    composed = cli.compose_serve_config(args)
    assert composed.serve.session.buckets == [1, 2] and composed.algo.name == "dreamer_v3"
    t = threading.Thread(target=cli.serve, args=(args,), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    actions = []
    for i in range(4):
        while True:
            try:
                resp = request_over_socket(("127.0.0.1", port), {"obs": {"rgb": _frames(i, 1)[0][0].tolist()}, "session_id": "u"})
                break
            except OSError:
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.1)
        actions.append(resp["actions"][0][0])
    t.join(timeout=30)
    assert not t.is_alive()
    # the served session equals the same steps through the engine directly
    engine = SessionEngine(policy, buckets=(1,))
    want = [int(engine.step_sessions(policy.params, policy.prepare({"rgb": _frames(i, 1)[0]}, 1), ["u"])[0][0]) for i in range(4)]
    assert actions == want


def test_torch_serve_device_resolution():
    assert cli.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="accelerator"):
        cli.resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.resolve_device("cuda")
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.compose_serve_config(["serve.port=0"])
