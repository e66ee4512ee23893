"""Serving hot swap. ``CheckpointWatcher`` against the JAX package's
(``sheeprl_tpu/serve/weights.py``): the same sequence of complete, torn
(never published) and rotted (published, unloadable) saves, each framework
writing its own format, gives the same decision at every poll: what is
published, what is struck and quarantined, and the error count. Then the
port's ``PolicyServer`` with a watcher, on the CPU: while 8 clients send
requests, each new save of a PPO run swaps in; versions only go up, no
request is dropped or torn, every answer equals the stateless policy built
from the save its version came from, and a rotted save is quarantined
while serving goes on. The staleness alarm turns the health probe to
``degraded``."""

import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu.fault import inject as jax_inject
from sheeprl_tpu.fault.manager import CheckpointManager as JaxManager
from sheeprl_tpu.serve.weights import CheckpointWatcher as JaxWatcher
from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo
from sheeprl_tpu_torch.config import SERVE_DEFAULTS, load_config
from sheeprl_tpu_torch.fault import inject as port_inject
from sheeprl_tpu_torch.fault.manager import CheckpointManager
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.serve.weights import CheckpointWatcher, WeightStore
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint, write_host_checkpoint


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stats:
    def __init__(self):
        self.watcher_errors = 0

    def add(self, name, value=1):
        setattr(self, name, getattr(self, name, 0) + value)


class _Store:
    """Records the step each published state carries."""

    def __init__(self, full_state: bool):
        self.full_state = full_state
        self.steps = []

    def publish_state(self, state):
        agent = state["agent"] if self.full_state else state
        self.steps.append(int(np.asarray(agent["w"]).reshape(-1)[0]))
        return len(self.steps)


def _state(step, torch_side):
    w = np.full((128, 128), float(step), np.float32)  # big enough for the JAX package's array sidecar
    return {"agent": {"w": torch.from_numpy(w) if torch_side else w}}


class _PortSaves:
    def __init__(self, d):
        self.d = d

    def complete(self, step):
        CheckpointManager().save(self.d / f"ckpt_{step}_0.ckpt", _state(step, True), step=step)

    def torn(self, step):  # written but never published
        write_host_checkpoint(self.d / f"ckpt_{step}_0.ckpt", _state(step, True))

    def rotted(self, step):
        port_inject.plant_torn_checkpoint(self.d, f"ckpt_{step}_0.ckpt", _state(step, True), step=step)


class _JaxSaves:
    def __init__(self, d):
        self.d = d

    def complete(self, step):
        JaxManager().save(self.d / f"ckpt_{step}_0.ckpt", _state(step, False), step=step)

    def torn(self, step):
        jax_save_state(self.d / f"ckpt_{step}_0.ckpt", _state(step, False))

    def rotted(self, step):
        jax_inject.plant_torn_checkpoint(self.d, f"ckpt_{step}_0.ckpt", _state(step, False), step=step)


SCRIPT = [("poll",), ("complete", 10), ("poll",), ("torn", 20), ("poll",), ("rotted", 30), ("poll",), ("poll",), ("poll",),
          ("poll",), ("complete", 40), ("poll",), ("poll",), ("complete", 35), ("poll",), ("rotted", 50), ("poll",),
          ("complete", 60), ("poll",), ("poll",)]


def _trace(saves, watcher, store, stats):
    out = []
    for action in SCRIPT:
        if action[0] == "poll":
            published = watcher.poll_once()
            out.append((published, list(store.steps), sorted(p.name for p in watcher.quarantined),
                        stats.watcher_errors, watcher.published))
        else:
            getattr(saves, action[0])(action[1])
    return out


@pytest.mark.parametrize("publish_current", [False, True], ids=["primed", "publish-current"])
def test_torch_serve_watch_decisions_equal_jax(tmp_path, publish_current):
    traces = {}
    for side in ("port", "jax"):
        d = tmp_path / side / "checkpoint"
        d.mkdir(parents=True)
        saves = _PortSaves(d) if side == "port" else _JaxSaves(d)
        saves.complete(5)  # the save the server was built from
        stats, store = _Stats(), _Store(full_state=side == "port")
        cls = CheckpointWatcher if side == "port" else JaxWatcher
        watcher = cls(d, store, poll_s=1.0, stats=stats, quarantine_after=3)
        if not publish_current:
            watcher._prime()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            traces[side] = _trace(saves, watcher, store, stats)
    assert traces["port"] == traces["jax"]
    last = traces["port"][-1]
    # the rotted 30 is struck at each poll until quarantined (3 errors); the
    # rotted 50 is struck once, then passed over for the complete 60 above it
    assert last[1][-2:] == [40, 60] and last[2] == ["ckpt_30_0.ckpt"] and last[3] == 4
    assert (last[1][0] == 5) is publish_current


def test_torch_serve_watch_store_publishes_complete_params(tmp_path):
    """The store builds fresh params and only then bumps the version; a pull
    returns one (version, params) pair; the stats count both."""
    stats = _Stats()
    built = []
    store = WeightStore({"w": torch.zeros(2)}, lambda s: built.append(s) or {"w": s["agent"]["w"].clone()}, stats)
    assert store.pull()[0] == 0
    v = store.publish_state({"agent": {"w": torch.ones(2)}})
    version, params = store.pull()
    assert v == version == 1 and torch.equal(params["w"], torch.ones(2)) and stats.publishes == 1 and stats.pulls == 2
    assert store.staleness_s < 5.0


PPO_TINY = ["preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "buffer.size=8",
            "algo.per_rank_batch_size=8", "algo.update_epochs=1", "metric.log_level=0", "algo.run_test=false",
            "checkpoint.every=16", "checkpoint.keep_last=0", "algo.total_steps=64"]


def test_torch_serve_watch_server_swaps_each_new_save_under_load(tmp_path):
    run = cli.run(PPO_TINY + [f"log_root={tmp_path / 'train'}"])
    src = Path(run["checkpoint"]).parent
    saves = sorted(src.glob("ckpt_*_0.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    assert [p.name for p in saves] == [f"ckpt_{s}_0.ckpt" for s in (16, 32, 48, 64)]
    cfg = load_config(find_run_config(saves[0]))
    watched = tmp_path / "served" / "checkpoint"
    manager = CheckpointManager()
    manager.save(watched / saves[0].name, load_checkpoint(saves[0]), step=16, config=dict(cfg))
    policy = serve_policy_ppo(cfg, load_checkpoint(watched / saves[0].name), "cpu")
    serve_cfg = {**SERVE_DEFAULTS["serve"], "port": None, "buckets": [1, 8], "max_wait_ms": 1.0,
                 "watch_poll_s": 0.05, "watcher_quarantine_after": 2}
    rng = np.random.default_rng(0)
    obs_pool = rng.standard_normal((64, 4)).astype(np.float32)
    answers, errors, stop = [], [], threading.Event()

    def client(i):
        k = i
        while not stop.is_set():
            rows = obs_pool[k % 64 : k % 64 + 1 + (k % 3)]
            try:
                actions, version = server.client.act({"state": rows}, n=len(rows), timeout=30)
                answers.append((i, version, rows.copy(), np.asarray(actions)))
            except Exception as e:  # a dropped request is a failure
                errors.append(repr(e))
            k += 7

    server = PolicyServer(policy, serve_cfg, watch_dir=watched)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        server.start()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        try:
            for path in saves[1:3]:
                before = server.weights.version
                manager.save(watched / path.name, load_checkpoint(path), step=int(path.name.split("_")[1]))
                _wait(lambda: server.weights.version > before)
            # a rotted save: published by the manifest, unloadable; serving goes on
            port_inject.plant_torn_checkpoint(watched, "ckpt_56_0.ckpt", load_checkpoint(saves[2]), step=56)
            _wait(lambda: len(server.watcher.quarantined) == 1)
            version_at_rot = server.weights.version
            before = version_at_rot
            manager.save(watched / saves[3].name, load_checkpoint(saves[3]), step=64)
            _wait(lambda: server.weights.version > before)
            time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            health = server.health()
            server.stop()
    assert not errors and len(answers) > 50
    assert version_at_rot == 2 and server.weights.version == 3
    history = {version: step for step, version, _ in server.watcher.history}
    assert history == {1: 32, 2: 48, 3: 64}
    steps = {0: 16, **history}
    policies = {v: serve_policy_ppo(cfg, load_checkpoint(watched / f"ckpt_{s}_0.ckpt"), "cpu")
                for v, s in steps.items()}
    seen = set()
    for _, version, rows, actions in answers:
        p = policies[version]
        want = p.greedy_fn(p.params, {"state": torch.from_numpy(rows)}).numpy()
        assert np.array_equal(actions, want), version  # each row from the save its version names: no torn batch
        seen.add(version)
    assert seen == {0, 1, 2, 3}
    for i in range(8):  # each client sees the versions only go up
        versions = [v for c, v, _, _ in answers if c == i]
        assert versions and versions == sorted(versions), i
    assert health["status"] == "ok" and health["watcher"]["published"] == 3
    assert health["watcher"]["quarantined"] == [str(watched / "ckpt_56_0.ckpt")] and health["watcher"]["errors"] == 2
    assert health["weights"]["step"] == 64 and health["weights"]["version"] == 3
    assert health["supervisor"]["workers"]["serve-ckpt-watcher"]["state"] == "running"


def test_torch_serve_watch_versions_never_go_back_per_client(tmp_path):
    """One client's answers carry non-decreasing versions across swaps."""
    store = WeightStore(0)
    seen = []

    def pull_loop():
        for _ in range(2000):
            seen.append(store.pull()[0])

    t = threading.Thread(target=pull_loop)
    t.start()
    for _ in range(50):
        store.publish_params(object())
    t.join(timeout=30)
    assert seen == sorted(seen) and store.version == 50


def test_torch_serve_watch_staleness_alarm_degrades_the_probe(tmp_path):
    run = cli.run(PPO_TINY + [f"log_root={tmp_path}", "algo.total_steps=16"])
    cfg = load_config(find_run_config(run["checkpoint"]))
    policy = serve_policy_ppo(cfg, load_checkpoint(run["checkpoint"]), "cpu")
    server = PolicyServer(policy, {"port": None, "buckets": [1], "max_staleness_s": 0.05})
    with server:
        assert server.health()["status"] in ("ok", "degraded")
        time.sleep(0.1)
        first, second = server.health(), server.health()
    assert first["status"] == "degraded" and first["weights"]["stale"] and "watcher" not in first
    assert second["status"] == "degraded" and server.stats.weights_stale == 1  # counted once per ok -> stale turn
    assert server.stats.snapshot()["Serve/weights_stale"] == 1


def test_torch_serve_watch_serve_config_takes_the_jax_defaults():
    from sheeprl_tpu.config import compose

    jax_serve = compose([], config_name="serve_config").serve
    for key in ("watch", "watch_poll_s", "watch_publish_current", "max_staleness_s", "watcher_quarantine_after"):
        assert SERVE_DEFAULTS["serve"][key] == jax_serve[key], key


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for the watcher")
        time.sleep(0.01)
