"""The port's process-group bring-up (``sheeprl_tpu_torch/parallel/distributed.py``)
against the JAX package's tests of ``maybe_init``
(``tests/test_utils/test_distributed_init.py``,
``tests/test_parallel/test_distributed_retry.py``), with
``torch.distributed.init_process_group`` stubbed as they stub
``jax.distributed.initialize``; the ``fabric.devices`` rule and the run-start
wire (``parallel/fabric.py``); and the four ``fabric`` keys a run took and
ignored before the pod (``fabric.pod.workers``, ``fabric.devices``,
``fabric.distributed.enabled``, ``fabric.grad_reduce_dtype``), through
``cli.run`` on the CPU. Under a group of more than one process every
algorithm but the PPO family's three refuses to train.
"""

import datetime

import pytest

import sheeprl_tpu_torch.parallel.distributed as dist
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import RUN_DEFAULTS
from sheeprl_tpu_torch.parallel import fabric
from sheeprl_tpu_torch.parallel.distributed import CoordinatorConnectError, maybe_init
from sheeprl_tpu_torch.utils.registry import TRAINERS


@pytest.fixture
def calls(monkeypatch):
    """Un-joined, no pod variables, a recording ``init_process_group``."""
    seen = []

    def fake_init(backend, init_method=None, world_size=None, rank=None, **kw):
        seen.append({"backend": backend, "init_method": init_method, "world_size": world_size, "rank": rank, **kw})

    monkeypatch.setattr(dist.dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "_initialized", False)
    for var in ("SHEEPRL_COORDINATOR", "SHEEPRL_NUM_PROCESSES", "SHEEPRL_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    yield seen
    dist._initialized = False


def test_torch_dist_init_single_process_is_a_noop(calls):
    assert maybe_init() is False
    assert maybe_init({"enabled": None}) is False
    assert calls == [] and dist.world_size() == 1 and dist.rank() == 0


def test_torch_dist_init_config_block_drives_init(calls):
    cfg = {"enabled": None, "coordinator": "10.0.0.1:1234", "num_processes": 4, "process_id": 2,
           "init_timeout_s": 45}
    assert maybe_init(cfg) is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2,
                      "timeout": datetime.timedelta(seconds=45)}]


def test_torch_dist_init_env_vars_win_over_config(calls, monkeypatch):
    monkeypatch.setenv("SHEEPRL_COORDINATOR", "10.0.0.9:4321")
    monkeypatch.setenv("SHEEPRL_NUM_PROCESSES", "8")
    monkeypatch.setenv("SHEEPRL_PROCESS_ID", "5")
    assert maybe_init({"coordinator": "10.0.0.1:1234", "num_processes": 4, "process_id": 2}) is True
    assert (calls[0]["init_method"], calls[0]["world_size"], calls[0]["rank"]) == ("tcp://10.0.0.9:4321", 8, 5)
    assert "timeout" not in calls[0]  # torch's default when init_timeout_s is unset


def test_torch_dist_init_keywords_win_over_env(calls, monkeypatch):
    monkeypatch.setenv("SHEEPRL_COORDINATOR", "10.0.0.9:4321")
    monkeypatch.setenv("SHEEPRL_NUM_PROCESSES", "8")
    monkeypatch.setenv("SHEEPRL_PROCESS_ID", "5")
    assert maybe_init(None, "127.0.0.1:7", 2, 1) is True
    assert (calls[0]["init_method"], calls[0]["world_size"], calls[0]["rank"]) == ("tcp://127.0.0.1:7", 2, 1)


def test_torch_dist_init_enabled_false_never_inits(calls, monkeypatch):
    monkeypatch.setenv("SHEEPRL_COORDINATOR", "127.0.0.1:9999")
    assert maybe_init({"enabled": False}) is False
    assert calls == []


def test_torch_dist_init_enabled_true_without_coordinator_is_typed(calls):
    with pytest.raises(ValueError, match="fabric.distributed.enabled=true but no coordinator"):
        maybe_init({"enabled": True})
    assert calls == []


def test_torch_dist_init_partial_group_is_typed(calls):
    """torch needs the world size and the rank, which JAX can detect."""
    with pytest.raises(ValueError, match="needs all of fabric.distributed.coordinator, num_processes and process_id"):
        maybe_init({"coordinator": "10.0.0.1:1"})


def test_torch_dist_init_second_call_is_a_noop(calls):
    cfg = {"coordinator": "10.0.0.1:1234", "num_processes": 2, "process_id": 0}
    assert maybe_init(cfg) is True
    assert maybe_init(cfg) is False
    assert len(calls) == 1


RETRY = {"coordinator": "10.1.2.3:7777", "num_processes": 2, "process_id": 1, "connect_retries": 2,
         "connect_backoff_s": 0.5}


def test_torch_dist_init_exhaustion_raises_typed_error_naming_coordinator(calls, monkeypatch):
    attempts, sleeps = [], []

    def refuse(*a, **kw):
        attempts.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist.dist, "init_process_group", refuse)
    monkeypatch.setattr(dist.time, "sleep", sleeps.append)
    with pytest.warns(UserWarning, match="retrying in 0.5s"):
        with pytest.raises(CoordinatorConnectError) as ei:
            maybe_init(RETRY)
    err = ei.value
    assert err.coordinator == "10.1.2.3:7777" and err.attempts == 3
    assert "10.1.2.3:7777" in str(err) and "3 attempt(s)" in str(err) and "connection refused" in str(err)
    assert isinstance(err.__cause__, RuntimeError)
    assert len(attempts) == 3 and sleeps == [0.5, 1.0]  # exponential backoff
    assert dist._initialized is False


def test_torch_dist_init_success_after_transient_failures(calls, monkeypatch):
    n, sleeps = {"calls": 0}, []

    def flaky(backend, init_method=None, world_size=None, rank=None, **kw):
        n["calls"] += 1
        if n["calls"] < 3:
            raise RuntimeError("coordinator not listening yet")
        assert (init_method, world_size, rank) == ("tcp://10.1.2.3:7777", 2, 1)

    monkeypatch.setattr(dist.dist, "init_process_group", flaky)
    monkeypatch.setattr(dist.time, "sleep", sleeps.append)
    with pytest.warns(UserWarning, match="attempt 2/3"):
        assert maybe_init(RETRY) is True
    assert n["calls"] == 3 and sleeps == [0.5, 1.0] and dist._initialized is True


def test_torch_dist_init_zero_retries_fails_on_first_attempt(calls, monkeypatch):
    def refuse(*a, **kw):
        raise OSError("no route to host")

    monkeypatch.setattr(dist.dist, "init_process_group", refuse)
    with pytest.raises(CoordinatorConnectError, match="1 attempt"):
        maybe_init({**RETRY, "connect_retries": 0})


# -- fabric: devices and the wire --------------------------------------------------


@pytest.mark.parametrize("devices,visible,want", [("auto", 1, 1), (None, 1, 1), (-1, 1, 1), (1, 1, 1), (1, 4, 1)])
def test_torch_dist_init_devices_resolve_as_jax_s(devices, visible, want):
    assert fabric.resolve_devices(devices, visible) == want


def test_torch_dist_init_devices_above_visible_raise_jax_s_error():
    with pytest.raises(ValueError, match="^Requested 2 devices but only 1 are visible$"):
        fabric.resolve_devices(2, 1)


@pytest.mark.parametrize("devices,n", [(2, 2), ("auto", 4), (-1, 4), (None, 4)])
def test_torch_dist_init_devices_above_one_name_the_pod(devices, n):
    with pytest.raises(NotImplementedError, match=rf"one device per process.*run --pod {n}"):
        fabric.resolve_devices(devices, 4)


@pytest.mark.parametrize("spec,world,want", [
    ("auto", 1, "float32"), ("auto", 2, "bfloat16"), (None, 2, "bfloat16"), ("float32", 2, "float32"),
    ("bf16", 1, "bfloat16"),
])
def test_torch_dist_init_setup_sets_the_wire_once(monkeypatch, spec, world, want):
    from sheeprl_tpu_torch.parallel import comm

    monkeypatch.setattr(dist, "world_size", lambda: world)
    monkeypatch.setattr(comm, "_WIRE", comm._WIRE)
    out = fabric.setup({"fabric": {"accelerator": "cpu", "devices": 1, "grad_reduce_dtype": spec}})
    assert out == {"devices": 1, "world_size": world, "rank": 0, "grad_reduce_dtype": want}
    assert comm.get_grad_reduce_dtype() == (None if want == "float32" else __import__("torch").bfloat16)


def test_torch_dist_init_run_defaults_carry_jax_s_fabric_blocks():
    """``configs/fabric/default.yaml``'s keys and defaults."""
    f = RUN_DEFAULTS["fabric"]
    assert f["devices"] == 1 and f["grad_reduce_dtype"] == "auto"
    assert f["distributed"] == {"enabled": None, "coordinator": None, "num_processes": None, "process_id": None,
                                "connect_retries": 3, "connect_backoff_s": 1.0, "init_timeout_s": None}
    assert f["pod"] == {"workers": 0, "devices_per_worker": 1, "coordinator_host": "127.0.0.1", "lease_s": 30.0,
                        "grace_s": 120.0, "beat_s": None, "max_restarts": 2, "backoff": 0.5,
                        "escalation": "degrade", "drain_s": 10.0, "join_s": 30.0, "tick_s": 0.25}


# -- the four keys a run took and ignored ------------------------------------------

DRY = ["preset=ppo", "fabric.accelerator=cpu", "dry_run=True", "metric.log_level=0", "algo.run_test=False"]


@pytest.fixture
def trained(monkeypatch, tmp_path):
    """``cli.run`` with the trainer's ``main`` recorded instead of run."""
    import importlib

    seen = []
    ppo = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo")
    monkeypatch.setattr(ppo, "main", lambda cfg, device: seen.append(cfg) or {})
    monkeypatch.setattr(dist, "_initialized", False)
    for var in ("SHEEPRL_COORDINATOR", "SHEEPRL_NUM_PROCESSES", "SHEEPRL_PROCESS_ID", "SHEEPRL_POD_RANK"):
        monkeypatch.delenv(var, raising=False)
    return seen, [f"log_root={tmp_path}"]


def test_torch_dist_init_pod_workers_key_runs_a_pod(trained, monkeypatch):
    import sheeprl_tpu_torch.parallel.pod as pod

    seen, extra = trained
    pods = []
    monkeypatch.setattr(pod, "run_pod", lambda cfg, argv: pods.append((cfg.fabric.pod.workers, argv)) or {"pod": 1})
    assert cli.run(DRY + ["fabric.pod.workers=2"] + extra) == {"pod": 1}
    assert seen == [] and pods[0][0] == 2 and "fabric.pod.workers=2" in pods[0][1]


def test_torch_dist_init_pod_workers_one_raises(trained):
    seen, extra = trained
    with pytest.raises(ValueError, match="fabric.pod.workers >= 2, got 1"):
        cli.run(DRY + ["fabric.pod.workers=1"] + extra)
    assert seen == []


def test_torch_dist_init_devices_key_raises(trained):
    seen, extra = trained
    with pytest.raises(ValueError, match="Requested 2 devices but only 1 are visible"):
        cli.run(DRY + ["fabric.devices=2"] + extra)
    assert seen == []


def test_torch_dist_init_devices_key_on_many_cards_names_the_pod(trained, monkeypatch):
    seen, extra = trained
    monkeypatch.setattr(fabric, "visible_devices", lambda accelerator: 2)
    with pytest.raises(NotImplementedError, match="run --pod 2"):
        cli.run(DRY + ["fabric.devices=2"] + extra)
    assert seen == []


def test_torch_dist_init_distributed_enabled_key_raises(trained):
    seen, extra = trained
    with pytest.raises(ValueError, match="fabric.distributed.enabled=true but no coordinator"):
        cli.run(DRY + ["fabric.distributed.enabled=true"] + extra)
    assert seen == []


def test_torch_dist_init_grad_reduce_dtype_key_raises(trained):
    seen, extra = trained
    with pytest.raises(ValueError, match="Unsupported fabric.grad_reduce_dtype: 'bogus'"):
        cli.run(DRY + ["fabric.grad_reduce_dtype=bogus"] + extra)
    assert seen == []


def test_torch_dist_init_default_keys_train_one_process(trained):
    seen, extra = trained
    cli.run(DRY + extra)
    assert len(seen) == 1 and seen[0].fabric.devices == 1 and seen[0].fabric.pod.workers == 0


# -- the family guard ----------------------------------------------------------------


@pytest.mark.parametrize("algo", sorted(set(TRAINERS) - set(cli.DATA_PARALLEL)))
def test_torch_dist_init_family_guard_refuses_a_group(algo):
    cli._require_data_parallel(algo, 1)  # one process: anything trains
    with pytest.raises(NotImplementedError, match=f"^{algo}: data-parallel training over 2 processes is not ported"):
        cli._require_data_parallel(algo, 2)


@pytest.mark.parametrize("algo", sorted(cli.DATA_PARALLEL))
def test_torch_dist_init_family_guard_lets_the_ppo_family_train(algo):
    cli._require_data_parallel(algo, 4)


def test_torch_dist_init_family_guard_runs_before_training(monkeypatch, tmp_path):
    """``run`` in a group of 2 refuses Dreamer V2 (not data-parallel yet)
    before its loop starts, and a pod of it is refused before any worker
    spawns."""
    import importlib

    import sheeprl_tpu_torch.parallel.pod as pod

    v2 = importlib.import_module("sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2")
    monkeypatch.setattr(v2, "main", lambda cfg, device: pytest.fail("Dreamer V2 trained in a group of 2"))
    monkeypatch.setattr(pod, "run_pod", lambda cfg, argv: pytest.fail("a Dreamer V2 pod spawned"))
    monkeypatch.setattr(dist, "world_size", lambda: 2)
    line = ["preset=dreamer_v2_atari_dummy", "fabric.accelerator=cpu", "dry_run=True", f"log_root={tmp_path}"]
    with pytest.raises(NotImplementedError, match="^dreamer_v2: data-parallel"):
        cli.run(line)
    with pytest.raises(NotImplementedError, match="^dreamer_v2: data-parallel"):
        cli.run(["--pod", "2"] + line)


def test_torch_dist_init_data_parallel_families_are_the_slice_s():
    assert cli.DATA_PARALLEL == {"ppo", "a2c", "ppo_recurrent", "sac", "droq", "sac_ae", "dreamer_v3"}


HYBRID_LINES = {
    "sac": ["preset=sac"],
    "rssm": ["preset=dreamer_v3_100k_atari_dummy"],
}


@pytest.mark.parametrize("family", list(HYBRID_LINES))
def test_torch_dist_init_hybrid_player_under_a_group_is_refused(monkeypatch, tmp_path, family):
    """A hybrid host player that resolves on (``true``, or ``auto`` on the
    card) is refused under a group before any worker spawns or trains; off
    (``auto`` on the CPU, or ``false``) the family trains data-parallel."""
    import sheeprl_tpu_torch.parallel.pod as pod

    monkeypatch.setattr(pod, "run_pod", lambda cfg, argv: pytest.fail("a hybrid pod spawned"))
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("SHEEPRL_POD_RANK", raising=False)
    base = HYBRID_LINES[family] + [f"log_root={tmp_path}"]
    for extra in (["algo.hybrid_player.enabled=true", "fabric.accelerator=cpu"], []):  # [] is auto on the card
        with pytest.raises(NotImplementedError, match="algo.hybrid_player.enabled=false.*Queue 1"):
            cli.run(["--pod", "2"] + base + extra)
    cfg = cli.compose_run_config(base + ["fabric.accelerator=cpu"])
    cli._require_coupled_player(cfg, 2)  # auto on the CPU: off
    cfg = cli.compose_run_config(base + ["algo.hybrid_player.enabled=false"])
    cli._require_coupled_player(cfg, 2)
    cli._require_coupled_player(cli.compose_run_config(base + ["algo.hybrid_player.enabled=true"]), 1)


def test_torch_dist_init_pod_without_a_card_refuses_before_spawning(monkeypatch, tmp_path):
    """A pod on the card needs a card: without one it raises before any
    worker spawns (fabric.accelerator=cpu runs it on the CPU)."""
    import sheeprl_tpu_torch.parallel.pod as pod

    monkeypatch.setattr(pod, "run_pod", lambda cfg, argv: pytest.fail("a pod spawned without a card"))
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SHEEPRL_POD_RANK", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--pod", "2", "preset=ppo", f"log_root={tmp_path}"])


@pytest.mark.parametrize("replicas", [0, 3], ids=["one_server", "fleet"])
def test_torch_dist_init_serve_joins_the_group(monkeypatch, replicas):
    """``serve`` and ``serve_fleet`` bring up the group from the same
    ``fabric.distributed`` block as ``run`` (JAX ``serve_algorithm`` and its
    fleet branch), before anything is served."""
    from sheeprl_tpu_torch.config import dotdict

    cfg = dotdict({"fabric": {"accelerator": "cpu", "precision": "32-true", "distributed": {"enabled": True}},
                   "serve": {"fleet": {"replicas": replicas}, "flywheel": {}}, "algo": {"name": "ppo"}})
    monkeypatch.setattr(cli, "compose_serve_config", lambda args: cfg)
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.delenv("SHEEPRL_COORDINATOR", raising=False)
    monkeypatch.delenv("SHEEPRL_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="fabric.distributed.enabled=true but no coordinator"):
        cli.serve(["checkpoint_path=x.ckpt"])
