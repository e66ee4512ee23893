"""The port's serve→train loop on the CPU: the transport, the server hooks,
the SAC learner-ingest, and the fault the slice repairs.

- Transport (JAX's ``tests/test_serve/test_flywheel.py``): feedback pairs
  with the previous action of its stream, streams never cross, missing and
  orphan feedback counted, the LRU over streams, shedding with the writer
  wedged, an ``observe`` that never raises, the partial flush, torn tails,
  quarantine, a fresh file per generation, the status file.
- The spool is the protocol between processes: the same ``observe`` calls
  through the JAX package's ``TrajectoryLog`` and the port's write the same
  bytes, and each side's ``SpoolReader`` reads the other's file row for row.
- ``learner_command`` is JAX's argv with only the module changed.
- Server hooks: feedback-less clients, the named rejection of wrong keys,
  per-connection pairing over the socket, the ``Serve/flywheel_*`` stats and
  the probe's block, zero surface when off, ``FlywheelConfigError`` at build.
- ``SACFlywheelIngest`` against JAX's from converted weights with JAX's
  draws injected (rebuilt from the ring key of each dispatch): parameters
  within 1e-6 after every ingest. JAX's fused append keeps only the first
  staged row of a flush (``sheeprl_tpu/algos/sac/sac.py``, ``staged[k][0]``),
  so the comparison stages one row a flush, where the two agree; the port
  appends every staged row (checked on its own).
- The fault: ``serve.flywheel.enabled=True`` was taken and ignored; now the
  server logs and spawns the learner, and a non-SAC algorithm raises.
"""

import json
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import apply_overrides, dotdict, plain, preset
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault.manager import CheckpointManager
from sheeprl_tpu_torch.serve import flywheel as flywheel_mod
from sheeprl_tpu_torch.serve.flywheel import (
    _FRAME,
    FRAME_MAGIC,
    FlywheelConfigError,
    SpoolReader,
    TrajectoryLog,
    flywheel_row_width,
    learner_command,
    read_learner_status,
    split_rows,
    write_learner_status,
)
from sheeprl_tpu_torch.serve.server import PolicyServer
from tests.torch_fleet_replica_main import build_policy

OBS_SPEC = {"x": ((2,), np.float32)}
SAC_TINY = ["env.num_envs=1", "algo.hidden_size=16", "algo.actor.hidden_size=16", "algo.critic.hidden_size=16",
            "algo.per_rank_batch_size=8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sac_cfg(extra=()):
    cfg = apply_overrides(preset("sac"), SAC_TINY + list(extra))
    cfg["spaces"] = dotdict(make_vector_env(cfg, 0).spaces)
    return cfg


def sac_checkpoint(tmp_path, step=100, extra=()):
    """A SAC checkpoint (seeded init, tiny widths) published in
    ``<tmp>/run/checkpoint`` with its run config beside it."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    cfg = sac_cfg(extra)
    agent, _ = build_agent(cfg, 3, cfg.spaces.actions, "cpu")
    path = tmp_path / "run" / "checkpoint" / f"ckpt_{step}_0.ckpt"
    CheckpointManager().save(path, {"agent": agent.state_dict()}, step=step, config=plain(cfg))
    return path


def _log(tmp_path, **kw):
    kw.setdefault("replica", "r0")
    return TrajectoryLog(tmp_path, OBS_SPEC, 3, **kw)


def _obs(*rows):
    return {"x": np.asarray(rows, np.float32)}


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


# -- the transport ------------------------------------------------------------------
def test_torch_flywheel_feedback_pairs_previous_action_and_round_trips(tmp_path):
    log = _log(tmp_path, block_rows=4, flush_s=0.01)
    a0 = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    log.observe(_obs([1.0, 2.0]), 1, a0, None, None, "s")
    log.observe(_obs([3.0, 4.0]), 1, [[4.0, 5.0, 6.0]], 0.5, 1.0, "s")
    log.close()
    assert log.counters["rows_logged"] == 1 and log.counters["rows_spooled"] == 1
    reader = SpoolReader(tmp_path, log.row_width)
    (replica, rows), = reader.poll()
    cols = split_rows(rows, 2, 3)
    assert replica == "r0" and reader.consumed_rows == {"r0": 1}
    np.testing.assert_array_equal(cols["observations"], [[1.0, 2.0]])
    np.testing.assert_array_equal(cols["actions"], a0)
    np.testing.assert_array_equal(cols["rewards"], [[0.5]])
    np.testing.assert_array_equal(cols["terminated"], [[1.0]])
    np.testing.assert_array_equal(cols["next_observations"], [[3.0, 4.0]])


def test_torch_flywheel_streams_pair_independently(tmp_path):
    log = _log(tmp_path, flush_s=0.01)
    log.observe(_obs([1.0, 0.0]), 1, [[1.0] * 3], None, None, "a")
    log.observe(_obs([2.0, 0.0]), 1, [[2.0] * 3], None, None, "b")
    log.observe(_obs([3.0, 0.0]), 1, [[3.0] * 3], 1.0, 0.0, "b")
    log.observe(_obs([4.0, 0.0]), 1, [[4.0] * 3], 2.0, 0.0, "a")
    log.close()
    cols = split_rows(np.concatenate([r for _, r in SpoolReader(tmp_path, log.row_width).poll()]), 2, 3)
    by_reward = {float(r): i for i, r in enumerate(cols["rewards"][:, 0])}
    np.testing.assert_array_equal(cols["actions"][by_reward[1.0]], [2.0] * 3)  # stream b
    np.testing.assert_array_equal(cols["actions"][by_reward[2.0]], [1.0] * 3)  # stream a


def test_torch_flywheel_feedback_missing_and_orphans_counted(tmp_path):
    log = _log(tmp_path)
    log.observe(_obs([0.0, 0.0]), 1, [[0.0] * 3], 1.0, 0.0, "s")
    assert log.counters["feedback_orphans"] == 1
    log.observe(_obs([0.0, 0.0]), 1, [[0.0] * 3], None, None, "s")
    assert log.counters["feedback_missing"] == 1
    log.observe(_obs([0.0, 0.0], [1.0, 1.0]), 2, [[0.0] * 3] * 2, [1.0, 1.0], None, "s")
    assert log.counters["feedback_orphans"] == 3 and log.counters["rows_logged"] == 0
    log.close()


def test_torch_flywheel_max_streams_lru_eviction_counts_missing(tmp_path):
    log = _log(tmp_path, max_streams=2)
    for i in range(4):
        log.observe(_obs([0.0, 0.0]), 1, [[0.0] * 3], None, None, f"s{i}")
    assert log.counters["feedback_missing"] == 2 and log.snapshot()["pending_streams"] == 2
    log.close()


def test_torch_flywheel_full_transport_sheds_instead_of_blocking(tmp_path, monkeypatch):
    log = _log(tmp_path, block_rows=2, queue_blocks=2, flush_s=3600.0)
    release = threading.Event()
    monkeypatch.setattr(log, "_write_frame", lambda rows: release.wait(30.0))
    while not log._q.full():  # the transport full, out of the free ring
        log._q.put_nowait((log._free.popleft(), 2))
    t0 = time.monotonic()
    for i in range(10):
        log.observe(_obs([float(i), 0.0]), 1, [[0.0] * 3], 1.0, 0.0, "s")
    assert time.monotonic() - t0 < 1.0
    assert log.counters["rows_shed"] >= 2 and log.counters["blocks_shed"] >= 1
    release.set()
    log.close(abandon=True)


def test_torch_flywheel_observe_never_raises(tmp_path):
    log = _log(tmp_path)
    log.observe({"wrong": "garbage"}, 1, None, 1.0, None, "s")
    assert log.counters["errors"] == 1
    log.close()


def test_torch_flywheel_partial_block_flushes_within_flush_s(tmp_path):
    log = _log(tmp_path, block_rows=256, flush_s=0.05)
    log.observe(_obs([1.0, 2.0]), 1, [[1.0] * 3], None, None, "s")
    log.observe(_obs([3.0, 4.0]), 1, [[2.0] * 3], 1.0, 0.0, "s")
    reader = SpoolReader(tmp_path, log.row_width)
    assert _wait(lambda: bool(reader.poll()) or reader.total_consumed == 1), "the partial block never flushed"
    log.close()


def test_torch_flywheel_torn_tail_waited_out_then_parsed(tmp_path):
    width = flywheel_row_width(2, 3)
    header = json.dumps({"magic": "sheeprl-flywheel/1", "replica": "r0", "row_width": width, "obs_dim": 2,
                         "act_dim": 3})
    payload = np.arange(width, dtype=np.float32).tobytes()
    frame = _FRAME.pack(FRAME_MAGIC, 1, len(payload)) + payload
    path = tmp_path / "r0.1.spool"
    path.write_bytes((header + "\n").encode() + frame[: len(frame) // 2])
    reader = SpoolReader(tmp_path, width)
    assert reader.poll() == [] and reader.pending_bytes() > 0
    path.write_bytes((header + "\n").encode() + frame)
    batches = reader.poll()
    assert len(batches) == 1 and reader.total_consumed == 1


def test_torch_flywheel_corrupt_frame_quarantines_file(tmp_path):
    width = flywheel_row_width(2, 3)
    header = json.dumps({"magic": "sheeprl-flywheel/1", "replica": "bad", "row_width": width})
    (tmp_path / "bad.1.spool").write_bytes((header + "\n").encode() + struct.pack("<III", 0xDEADBEEF, 1, 4) + b"\0" * 4)
    reader = SpoolReader(tmp_path, width)
    assert reader.poll() == [] and reader.corrupt_files == 1
    assert reader.poll() == [] and reader.corrupt_files == 1


def test_torch_flywheel_new_generation_gets_fresh_spool_file(tmp_path):
    a, b = _log(tmp_path), _log(tmp_path)
    assert a.path != b.path
    a.close()
    b.close()


def test_torch_flywheel_learner_status_round_trip_and_staleness(tmp_path):
    assert read_learner_status(tmp_path) is None
    write_learner_status(tmp_path, {"consumed_rows": 7, "grad_steps": 3})
    status = read_learner_status(tmp_path)
    assert status["consumed_rows"] == 7 and status["staleness_s"] >= 0.0


# -- the spool between processes: byte for byte JAX's ------------------------------------
def _observe_script(log):
    rng = np.random.default_rng(3)
    for t in range(11):
        for s in ("a", "b"):
            n = 1 if s == "a" else 2
            log.observe({"x": rng.normal(size=(n, 2)).astype(np.float32)}, n, rng.normal(size=(n, 3)),
                        None if t == 0 else rng.normal(size=n), None if t % 3 else np.ones(n), s)
    log.close()


def test_torch_flywheel_spool_bytes_equal_jax(tmp_path):
    from sheeprl_tpu.serve.flywheel import TrajectoryLog as JaxTrajectoryLog

    logs = {}
    for side, cls in (("jax", JaxTrajectoryLog), ("port", TrajectoryLog)):
        logs[side] = cls(tmp_path / side, OBS_SPEC, 3, replica="r0", block_rows=4, queue_blocks=64, flush_s=3600.0)
        _observe_script(logs[side])
    assert logs["port"].counters == logs["jax"].counters and logs["port"].counters["rows_logged"] == 30
    assert logs["port"].path.read_bytes() == logs["jax"].path.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_flywheel_spool_reads_row_for_row_across_packages(tmp_path, writer):
    from sheeprl_tpu.serve.flywheel import SpoolReader as JaxSpoolReader
    from sheeprl_tpu.serve.flywheel import TrajectoryLog as JaxTrajectoryLog

    cls = JaxTrajectoryLog if writer == "jax" else TrajectoryLog
    log = cls(tmp_path, OBS_SPEC, 3, replica=f"{writer}-0", block_rows=3, queue_blocks=64, flush_s=0.01)
    _observe_script(log)
    got = {}
    for side, reader_cls in (("jax", JaxSpoolReader), ("port", SpoolReader)):
        reader = reader_cls(tmp_path, log.row_width)
        got[side] = (reader.poll(), dict(reader.consumed_rows))
    assert got["jax"][1] == got["port"][1] == {f"{writer}-0": 30}
    assert [r for r, _ in got["jax"][0]] == [r for r, _ in got["port"][0]]
    np.testing.assert_array_equal(np.concatenate([rows for _, rows in got["jax"][0]]),
                                  np.concatenate([rows for _, rows in got["port"][0]]))


@pytest.mark.parametrize("cfg", [
    {"checkpoint_path": "/ckpt/ckpt_2_0.ckpt", "seed": 5, "fabric": {"accelerator": "cpu"},
     "serve": {"flywheel": {"publish_rows": 16, "poll_s": 0.1}}},
    {"checkpoint_path": "/c/ckpt_9_0.ckpt", "fabric": {}, "serve": {"flywheel": {
        "ingest_rows": 4, "grad_max": 2, "replay_ratio": 1.0, "learning_starts_rows": 8, "buffer_size": 64,
        "max_rows": 100}}},
], ids=["publish", "ingest"])
def test_torch_flywheel_learner_command_matches_jax(cfg):
    from sheeprl_tpu.config import dotdict as jax_dotdict
    from sheeprl_tpu.serve.flywheel import learner_command as jax_learner_command

    want = jax_learner_command(jax_dotdict(cfg), "/tmp/fly")
    got = learner_command(dotdict(cfg), "/tmp/fly")
    assert want[:3] == [got[0], "-m", "sheeprl_tpu"] and got[:3] == [want[0], "-m", "sheeprl_tpu_torch"]
    assert got[3:] == want[3:]
    assert "--from-serve" in got and "/tmp/fly" in got


# -- the server's hooks ----------------------------------------------------------------
@pytest.fixture(scope="module")
def sac_policy():
    from sheeprl_tpu_torch.algos.sac.evaluate import serve_policy_sac

    return serve_policy_sac(sac_cfg(), None, "cpu")


def _fly_cfg(tmp_path, port=None, **fly):
    return {"buckets": [1, 4], "max_wait_ms": 1.0, "port": port,
            "flywheel": {"enabled": True, "dir": str(tmp_path / "fly"), "replica": "r0", "flush_s": 0.01, **fly}}


def test_torch_flywheel_feedbackless_client_serves_normally(sac_policy, tmp_path):
    rng = np.random.default_rng(0)
    with PolicyServer(sac_policy, _fly_cfg(tmp_path)) as server:
        for _ in range(3):
            actions, version = server.client.act({"state": rng.standard_normal(3).astype(np.float32)}, n=1)
            assert actions.shape == (1, 1) and version == 0
        assert _wait(lambda: server.flywheel.counters["feedback_missing"] >= 2)
        snap = server.flywheel.snapshot()
    assert snap["rows_logged"] == 0 and snap["feedback_missing"] == 2 and snap["errors"] == 0


def test_torch_flywheel_unknown_obs_keys_still_rejected_with_named_error(sac_policy, tmp_path):
    with PolicyServer(sac_policy, _fly_cfg(tmp_path, port=0)) as server:
        with socket.create_connection(server.address, timeout=10.0) as sock:
            f = sock.makefile("rw")
            f.write(json.dumps({"obs": {"bogus": [1.0]}, "n": 1, "reward": 1.0}) + "\n")
            f.flush()
            resp = json.loads(f.readline())
            assert "error" in resp and "state" in resp["error"]
            f.write(json.dumps({"obs": {"state": [0.1, 0.2, 0.3]}, "n": 1, "reward": 0.5, "done": 0.0}) + "\n")
            f.flush()
            assert "actions" in json.loads(f.readline())
        with pytest.raises(ValueError, match="observation keys"):
            server.scheduler.submit({"bogus": np.zeros((1, 3), np.float32)}, reward=1.0, done=0.0, stream="s")


def test_torch_flywheel_socket_feedback_pairs_per_connection(sac_policy, tmp_path):
    with PolicyServer(sac_policy, _fly_cfg(tmp_path, port=0)) as server:
        conns = [socket.create_connection(server.address, timeout=10.0) for _ in range(2)]
        files = [c.makefile("rw") for c in conns]
        for extra in ({}, None):
            for i, f in enumerate(files):
                msg = {"obs": {"state": [0.1, 0.2, 0.3]}, "n": 1}
                if extra is None:
                    msg.update(reward=float(i + 1), done=0.0)
                f.write(json.dumps(msg) + "\n")
                f.flush()
                assert "actions" in json.loads(f.readline())
        assert _wait(lambda: server.flywheel.counters["rows_spooled"] >= 2)
        snap = server.flywheel.snapshot()
        for c in conns:
            c.close()
    assert snap["rows_logged"] == 2 and snap["feedback_orphans"] == 0
    rows = np.concatenate([r for _, r in SpoolReader(tmp_path / "fly", flywheel_row_width(3, 1)).poll()])
    assert sorted(split_rows(rows, 3, 1)["rewards"][:, 0].tolist()) == [1.0, 2.0]


def test_torch_flywheel_stats_and_health_block(sac_policy, tmp_path):
    with PolicyServer(sac_policy, _fly_cfg(tmp_path)) as server:
        obs = {"state": np.asarray([0.1, 0.2, 0.3], np.float32)}
        server.client.act(obs, n=1)
        server.client.act(obs, n=1, reward=1.0, done=0.0)
        assert _wait(lambda: server.flywheel.counters["rows_spooled"] >= 1)
        stats, health = server.stats.snapshot(), server.health()
    assert (stats["Serve/flywheel_rows"], stats["Serve/flywheel_shed"], stats["Serve/flywheel_spooled"],
            stats["Serve/flywheel_errors"]) == (1, 0, 1, 0)
    fl = health["flywheel"]
    assert fl["replica"] == "r0" and fl["rows_logged"] == 1 and fl["rows_shed"] == 0 and "learner" not in fl


def test_torch_flywheel_off_means_zero_surface():
    with PolicyServer(build_policy(False), {"buckets": [1, 4], "max_wait_ms": 1.0, "port": None}) as server:
        server.client.act({"x": np.ones(2, np.float32)}, n=1)
        assert server.flywheel is None
        health, stats = server.health(), server.stats.snapshot()
    assert "flywheel" not in health and not any(k.startswith("Serve/flywheel") for k in stats)


def test_torch_flywheel_config_error_for_unsupported_algo(tmp_path):
    with pytest.raises(FlywheelConfigError) as exc:
        PolicyServer(build_policy(False), {"buckets": [1], "port": None,
                                           "flywheel": {"enabled": True, "dir": str(tmp_path)}})
    assert "'toy'" in str(exc.value) and "sac" in str(exc.value)


def test_torch_flywheel_config_error_without_dir(sac_policy):
    with pytest.raises(FlywheelConfigError, match="serve.flywheel.dir"):
        PolicyServer(sac_policy, {"buckets": [1], "port": None, "flywheel": {"enabled": True}})


# -- the SAC learner-ingest against JAX's ---------------------------------------------------
INGEST = {"ingest_rows": 1, "grad_max": 2, "replay_ratio": 2.0, "learning_starts_rows": 4, "buffer_size": 16}
HIDDEN, BATCH = 16, 8


def _jax_ingest():
    import gymnasium as gym

    from sheeprl_tpu.config import compose
    from sheeprl_tpu.parallel import Fabric
    from sheeprl_tpu.utils.registry import get_entrypoint, resolve_flywheel_ingest

    cfg = compose(["exp=sac", "env=gym", "env.id=Pendulum-v1", "env.capture_video=False", "fabric.devices=1",
                   "metric.log_level=0", "algo.mlp_keys.encoder=[state]", f"algo.hidden_size={HIDDEN}",
                   f"algo.per_rank_batch_size={BATCH}"])
    cfg["serve"] = {"flywheel": dict(INGEST)}
    fabric = Fabric(devices=1, accelerator="cpu")
    obs = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    act = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    return get_entrypoint(resolve_flywheel_ingest("sac"))(fabric, cfg, obs, act, None)


def _jax_draws(key, count, valid, grad_max):
    """The uniform resident dispatch's draws from its ring key (JAX
    ``make_resident_train_step``'s pre-gathered variant, one env)."""
    _, sub = jax.random.split(key)
    k_pos, _k_env, k_scan = jax.random.split(sub, 3)
    pos = np.asarray(jax.random.randint(k_pos, (grad_max, BATCH), 0, max(valid, 1)))
    noise = {"next": [], "actor": []}
    for k in jax.random.split(jax.random.fold_in(k_scan, 0), grad_max):
        k_next, k_actor = jax.random.split(k)
        noise["next"].append(np.asarray(jax.random.normal(k_next, (BATCH, 1))))
        noise["actor"].append(np.asarray(jax.random.normal(k_actor, (BATCH, 1))))
    out = {"pos": torch.from_numpy(pos[:count]).to(torch.int64),
           "env": torch.zeros((count, BATCH), dtype=torch.int64)}
    out.update({k: torch.from_numpy(np.stack(v)[:count]) for k, v in noise.items()})
    return out


def test_torch_flywheel_sac_ingest_matches_jax():
    from sheeprl_tpu_torch.algos.sac.flywheel import SACFlywheelIngest
    from sheeprl_tpu_torch.utils.convert import sac_state_from_jax

    jax_ingest = _jax_ingest()
    keys = []
    jax_fn = jax_ingest._fn

    def recording(params, aopt, copt, lopt, state, blob):
        keys.append(np.array(state["key"]))  # the dispatch donates the ring state
        return jax_fn(params, aopt, copt, lopt, state, blob)

    jax_ingest._fn = recording
    cfg = sac_cfg([f"algo.per_rank_batch_size={BATCH}"])
    cfg["serve"] = {"flywheel": dict(INGEST)}
    box = {}
    port = SACFlywheelIngest(cfg, sac_state_from_jax(jax.tree.map(np.asarray, jax_ingest.params)), "cpu",
                             draws=lambda count, valid: _jax_draws(keys[box["port"].dispatches], count, valid, 2))
    box["port"] = port
    rng = np.random.default_rng(0)
    for m in (3, 2, 4, 1):
        rows = rng.standard_normal((m, port.row_width)).astype(np.float32)
        rows[:, 5] = (rng.uniform(size=m) < 0.2).astype(np.float32)  # the terminated column
        jax_ingest.ingest(rows)
        port.ingest(rows)
        assert (port.consumed, port.grad_steps, port.dispatches) == (jax_ingest.consumed, jax_ingest.grad_steps,
                                                                      len(keys))
        want = sac_state_from_jax(jax.tree.map(np.asarray, jax_ingest.params))
        got = port.agent_state()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert port.grad_steps == 14  # 2 a row from the 4th row on


def test_torch_flywheel_sac_ingest_appends_every_staged_row_and_learns():
    from sheeprl_tpu_torch.algos.sac.flywheel import SACFlywheelIngest

    cfg = sac_cfg()
    cfg["serve"] = {"flywheel": {"ingest_rows": 4, "grad_max": 2, "replay_ratio": 1.0, "learning_starts_rows": 8,
                                 "buffer_size": 64}}
    ingest = SACFlywheelIngest(cfg, None, "cpu")
    assert ingest.row_width == flywheel_row_width(3, 1)
    before = {k: v.clone() for k, v in ingest.agent_state().items()}
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((12, ingest.row_width)).astype(np.float32)
    ingest.ingest(rows[:4])
    assert ingest.consumed == 4 and ingest.grad_steps == 0
    np.testing.assert_array_equal(ingest.drb.storage["observations"][:4, 0].numpy(), rows[:4, :3])
    ingest.ingest(rows[4:])
    assert ingest.consumed == 12 and ingest.grad_steps > 0 and ingest.drb.valid_rows == 12
    cols = split_rows(rows, 3, 1)
    for k in ingest.specs:
        np.testing.assert_array_equal(ingest.drb.storage[k][:12, 0].numpy(), cols[k])
    moved = [k for k, v in ingest.agent_state().items() if k.startswith("actor.") and not torch.equal(v, before[k])]
    assert moved, "the actor did not move after the granted steps"


def test_torch_flywheel_sac_ingest_backlog_is_capped():
    from sheeprl_tpu_torch.algos.sac.flywheel import SACFlywheelIngest

    cfg = sac_cfg()
    cfg["serve"] = {"flywheel": {"ingest_rows": 8, "grad_max": 2, "replay_ratio": 4.0, "learning_starts_rows": 1,
                                 "buffer_size": 64}}
    ingest = SACFlywheelIngest(cfg, None, "cpu")
    ingest.ingest(np.zeros((8, ingest.row_width), np.float32))
    # 8 rows x 4 = 32 grants, capped at grad_max x 4 = 8: drained at 2 a dispatch down to below 2
    assert ingest.grad_steps == 8 and ingest.dispatches == 4


def test_torch_flywheel_published_agent_state_swaps_into_the_server(sac_policy):
    from sheeprl_tpu_torch.algos.sac.flywheel import SACFlywheelIngest

    cfg = sac_cfg()
    cfg["serve"] = {"flywheel": {"ingest_rows": 4, "grad_max": 2, "replay_ratio": 2.0, "learning_starts_rows": 4,
                                 "buffer_size": 32}}
    ingest = SACFlywheelIngest(cfg, None, "cpu")
    ingest.ingest(np.random.default_rng(2).standard_normal((8, ingest.row_width)).astype(np.float32))
    obs = {"state": np.asarray([0.1, 0.2, 0.3], np.float32)}
    with PolicyServer(sac_policy, {"buckets": [1], "port": None, "max_wait_ms": 1.0}) as server:
        before, _ = server.client.act(obs)
        assert server.weights.publish_state({"agent": ingest.agent_state(), "flywheel_rows": 8}) == 1
        after, version = server.client.act(obs)
    assert version == 1 and not np.array_equal(before, after)
    want = ingest.agent.greedy_action(torch.as_tensor(obs["state"])[None]).detach().numpy()
    np.testing.assert_allclose(after, want, atol=1e-6)


# -- the fault this slice repairs: serve.flywheel.enabled was taken and ignored ----------------
class _FakeLearner:
    made = []

    def __init__(self, cfg, directory):
        self.directory = directory
        self.ticks = 0
        self.stopped = False
        _FakeLearner.made.append(self)

    def tick(self):
        self.ticks += 1

    def probe(self):
        return {"alive": True}

    def stop(self, grace_s=None):
        self.stopped = True


def test_torch_flywheel_enabled_logs_and_spawns_the_learner(tmp_path, monkeypatch):
    ckpt = sac_checkpoint(tmp_path)
    _FakeLearner.made = []
    monkeypatch.setattr(flywheel_mod, "LearnerSupervisor", _FakeLearner)
    cli.main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.flywheel.enabled=True",
              "serve.max_requests=0", "serve.port=0"])
    (learner,) = _FakeLearner.made
    assert learner.directory == str(ckpt.parent / "flywheel") and learner.ticks >= 1 and learner.stopped
    assert len(list((ckpt.parent / "flywheel").glob("replica-*.spool"))) == 1  # the server's log


@pytest.mark.parametrize("argv", [["--flywheel"], ["--flywheel", "SPOOL"], ["--flywheel=SPOOL"]],
                         ids=["bare", "dir", "equals"])
def test_torch_flywheel_flag_turns_the_loop_on(tmp_path, monkeypatch, argv):
    ckpt = sac_checkpoint(tmp_path)
    _FakeLearner.made = []
    monkeypatch.setattr(flywheel_mod, "LearnerSupervisor", _FakeLearner)
    argv = [a.replace("SPOOL", str(tmp_path / "spool")) for a in argv]
    cli.main(["serve", *argv, f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.max_requests=0",
              "serve.port=0"])
    want = str(tmp_path / "spool") if len(argv) > 1 or "=" in argv[0] else str(ckpt.parent / "flywheel")
    assert [m.directory for m in _FakeLearner.made] == [want]


def test_torch_flywheel_enabled_on_a_ppo_checkpoint_raises(tmp_path):
    from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo

    cfg = apply_overrides(preset("ppo"), ["env.num_envs=1"])
    cfg["spaces"] = dotdict(make_vector_env(cfg, 0).spaces)
    policy = serve_policy_ppo(cfg, None, "cpu")
    ckpt = tmp_path / "checkpoint" / "ckpt_8_0.ckpt"
    CheckpointManager().save(ckpt, {"agent": policy.params.state_dict()}, step=8, config=plain(cfg))
    with pytest.raises(FlywheelConfigError, match="'ppo'"):
        cli.main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.flywheel.enabled=True",
                  "serve.max_requests=0", "serve.port=0"])
    assert not (ckpt.parent / "flywheel").exists() or not list((ckpt.parent / "flywheel").glob("*.spool"))


@pytest.mark.parametrize("argv, want", [
    (["run", "--from-serve", "D", "checkpoint_path=c"], ("D", ["checkpoint_path=c"])),
    (["run", "--from-serve=D", "checkpoint_path=c", "seed=3"], ("D", ["checkpoint_path=c", "seed=3"])),
    (["--from-serve", "D", "checkpoint_path=c"], ("D", ["checkpoint_path=c"])),
], ids=["flag", "equals", "no_verb"])
def test_torch_flywheel_from_serve_flag_runs_the_learner(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(cli, "learn_from_serve", lambda args, d: seen.append((d, list(args))))
    cli.main(argv)
    assert seen == [want]


@pytest.mark.parametrize("argv", [["run", "--from-serve"], ["run", "--from-serve", "x=1"], ["run", "--from-serve="]],
                         ids=["missing", "override", "empty"])
def test_torch_flywheel_from_serve_needs_a_directory(argv):
    with pytest.raises(ValueError, match="--from-serve needs the flywheel spool directory"):
        cli.main(argv)
