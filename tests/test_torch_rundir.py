"""Per-run directories. ``get_log_dir`` against the JAX package's
(``sheeprl_tpu/utils/logger.py``): the same directory scripts give the same
``version_N`` paths; a composed run is named as the JAX composition names it
(``exp_name``, ``root_dir``, a timestamped ``run_name``); a resume drops the
same keys of the old config as ``sheeprl_tpu/cli.py``'s
``resume_from_checkpoint``, warns as it does and raises its errors; and
``resume_from=latest`` picks the checkpoint the JAX resolver picks on the
same run tree.

Then the four ways runs mixed their checkpoints when every run of a preset
and seed shared one directory (each test fails on a port that builds
``<log_root>/<algo>/<env>/seed_<seed>``): a second run's saves deleted by
keep-last retention, a sentinel rollback into another run's checkpoint,
``resume_from=latest`` resuming the wrong run, and a second run
overwriting the first one's ``config.json``."""

import json
import re
from pathlib import Path

import pytest
import torch
import yaml

from sheeprl_tpu.cli import resume_from_checkpoint as jax_resume_from_checkpoint
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.fault.manager import CheckpointManager as JaxManager
from sheeprl_tpu.fault.manager import find_latest_run_checkpoint as jax_find_latest
from sheeprl_tpu.utils.logger import get_log_dir as jax_get_log_dir
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import load_config
from sheeprl_tpu_torch.fault.manager import CheckpointManager, find_latest_run_checkpoint, read_manifest
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir

PPO_TINY = ["preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8", "buffer.size=8",
            "algo.per_rank_batch_size=8", "algo.update_epochs=1", "metric.log_level=0", "algo.run_test=false",
            "checkpoint.every=16", "algo.total_steps=64", "seed=3"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIR_SCRIPTS = {
    "empty": ([], []),
    "gaps": (["version_0", "version_3"], []),
    "junk": (["version_1", "version_x", "version_", "other", "versions_9"], ["version_7"]),
    "high": (["version_12", "version_2"], ["notes.txt"]),
}


@pytest.mark.parametrize("script", list(DIR_SCRIPTS))
def test_torch_rundir_get_log_dir_equals_jax(script, tmp_path):
    dirs, files = DIR_SCRIPTS[script]
    got = {}
    for side, fn in (("port", get_log_dir), ("jax", jax_get_log_dir)):
        root = tmp_path / side
        base = root / "ppo" / "CartPole-v1" / "run"
        base.mkdir(parents=True)
        for d in dirs:
            (base / d).mkdir()
        for f in files:
            (base / f).write_text("")
        paths = [fn({"log_root": str(root)}, "ppo/CartPole-v1", "run") for _ in range(2)]
        assert all(Path(p).is_dir() for p in paths)
        got[side] = [Path(p).relative_to(root).as_posix() for p in paths]
    assert got["port"] == got["jax"]


def test_torch_rundir_run_names_match_the_jax_composition():
    port = cli.compose_run_config(["preset=ppo", "seed=7"])
    jax = jax_compose(["exp=ppo", "seed=7"])
    stamp = re.compile(r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}_")
    assert port.exp_name == jax.exp_name == "ppo_CartPole-v1" and port.root_dir == jax.root_dir == "ppo/CartPole-v1"
    assert stamp.sub("", port.run_name) == stamp.sub("", jax.run_name) == "ppo_CartPole-v1_7"
    assert stamp.match(port.run_name) and port.log_root == jax.log_root == "logs/runs"
    named = cli.compose_run_config(["preset=ppo", "run_name=mine", "root_dir=elsewhere"])
    assert (named.run_name, named.root_dir) == ("mine", "elsewhere")


def _old_run(tmp_path, side, old):
    run_dir = tmp_path / side / "old_run" / "version_0"
    (run_dir / "checkpoint").mkdir(parents=True)
    ckpt = run_dir / "checkpoint" / "ckpt_16_0.ckpt"
    ckpt.write_bytes(b"")
    old = json.loads(json.dumps(old))  # plain dicts and lists
    if side == "jax":
        (run_dir / "config.yaml").write_text(yaml.safe_dump(old))
    else:
        (run_dir / "config.json").write_text(json.dumps(old))
    return ckpt


def _old_config(base):
    old = {k: v for k, v in base.items()}
    old.update(root_dir="old/root", run_name="old_run_name", log_root="/old/logs", seed=99)
    old["algo"] = {**base["algo"], "learning_starts": 7, "hidden_size": 48}
    old["checkpoint"] = {**base["checkpoint"], "resume_from": "/old/ckpt", "every": 1234}
    return old


def test_torch_rundir_resume_drops_the_jax_keys(tmp_path):
    """Both keep the old run's settings but its directory, resume_from and
    learning_starts, which come from the new composition."""
    from sheeprl_tpu_torch.config import plain

    jax_fresh = jax_compose(["exp=sac", "log_root=/new/logs"])
    jax_ckpt = _old_run(tmp_path, "jax", _old_config(jax_fresh))
    jax_fresh.checkpoint.resume_from = str(jax_ckpt)
    port_base = plain(cli.compose_run_config(["preset=sac"]))
    port_ckpt = _old_run(tmp_path, "port", _old_config(port_base))
    with pytest.warns(UserWarning, match="pre-fill the buffer for `algo.learning_starts` steps") as jw:
        jax = jax_resume_from_checkpoint(jax_fresh)
    with pytest.warns(UserWarning, match="pre-fill the buffer for `algo.learning_starts` steps") as pw:
        port = cli.compose_run_config(["preset=sac", f"checkpoint.resume_from={port_ckpt}", "log_root=/new/logs"])
    assert [str(w.message) for w in pw if "pre-fill" in str(w.message)] == \
        [str(w.message) for w in jw if "pre-fill" in str(w.message)]
    for cfg, ckpt in ((jax, jax_ckpt), (port, port_ckpt)):
        # kept from the old run
        assert cfg.seed == 99 and cfg.algo.hidden_size == 48 and cfg.checkpoint.every == 1234
        # dropped: the new run's own
        assert cfg.log_root == "/new/logs" and cfg.run_name != "old_run_name" and cfg.root_dir != "old/root"
        assert cfg.algo.learning_starts == 100 and cfg.checkpoint.resume_from == str(ckpt)
    assert port.root_dir == "sac/Pendulum-v1"
    assert re.sub(r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}_", "", port.run_name) == "sac_Pendulum-v1_99"


@pytest.mark.parametrize("what", ["env", "algo"])
def test_torch_rundir_resume_refuses_another_env_or_algo_as_jax(what, tmp_path):
    from sheeprl_tpu_torch.config import plain

    jax_fresh = jax_compose(["exp=sac"])
    port_base = plain(cli.compose_run_config(["preset=sac"]))
    jax_old, port_old = _old_config(jax_fresh), _old_config(port_base)
    for old in (jax_old, port_old):
        if what == "env":
            old["env"] = {**old["env"], "id": "MountainCarContinuous-v0"}
        else:
            old["algo"] = {**old["algo"], "name": "droq"}
    jax_fresh.checkpoint.resume_from = str(_old_run(tmp_path, "jax", jax_old))
    port_ckpt = _old_run(tmp_path, "port", port_old)
    with pytest.raises(ValueError) as jax_err:
        jax_resume_from_checkpoint(jax_fresh)
    with pytest.raises(ValueError) as port_err:
        cli.compose_run_config(["preset=sac", f"checkpoint.resume_from={port_ckpt}", "env.id=Pendulum-v1"])
    assert str(port_err.value) == str(jax_err.value).replace("LunarLanderContinuous-v3", "Pendulum-v1")
    assert ("different environment" if what == "env" else "different algorithm") in str(port_err.value)


def _write_tree(root: Path, side: str, layout, torn: bool):
    """``layout``: (run_name, version, [steps...]) in write order; a step
    written as a negative number is a save published by neither manifest: a
    whole file written without the manager, or with ``torn`` the ``.tmp``
    leftover of a save killed before its rename."""
    for run_name, version, steps in layout:
        d = root / run_name / f"version_{version}" / "checkpoint"
        for step in steps:
            path = d / f"ckpt_{abs(step)}_0.ckpt"
            state = {"agent": {"w": torch.zeros(2)}} if side == "port" else {"agent": {"w": torch.zeros(2).numpy()}}
            if step < 0 and torn:
                d.mkdir(parents=True, exist_ok=True)
                path.with_name(path.name + ".tmp").write_bytes(b"\x80\x04partial")
            elif step < 0:
                d.mkdir(parents=True, exist_ok=True)
                if side == "port":
                    from sheeprl_tpu_torch.utils.checkpoint import write_host_checkpoint

                    write_host_checkpoint(path, state)
                else:
                    from sheeprl_tpu.utils.checkpoint import save_state

                    save_state(path, state)
            elif side == "port":
                CheckpointManager().save(path, state, step=step)
            else:
                JaxManager().save(path, state, step=step)


TREES = {
    "newest run, lower step": [("a_run", 0, [16, 32, 48]), ("b_run", 0, [16])],
    "versions of one run name": [("same", 0, [16, 32]), ("same", 1, [48]), ("same", 2, [8])],
    "torn newest": [("a_run", 0, [16]), ("b_run", 0, [32, -64])],
    "unpublished whole newest": [("a_run", 0, [16]), ("b_run", 0, [32, -64])],
}


@pytest.mark.parametrize("tree", list(TREES))
def test_torch_rundir_resume_latest_picks_what_jax_picks(tree, tmp_path):
    picked = {}
    for side, find in (("port", find_latest_run_checkpoint), ("jax", jax_find_latest)):
        root = tmp_path / side / "ppo" / "CartPole-v1"
        _write_tree(root, side, TREES[tree], torn=tree == "torn newest")
        picked[side] = Path(find(root)).relative_to(root).as_posix()
    assert picked["port"] == picked["jax"]
    assert picked["port"] == {"newest run, lower step": "b_run/version_0/checkpoint/ckpt_16_0.ckpt",
                              "versions of one run name": "same/version_2/checkpoint/ckpt_8_0.ckpt",
                              "torn newest": "b_run/version_0/checkpoint/ckpt_32_0.ckpt",
                              # both frameworks' bare scan takes a whole file the manifest lacks
                              "unpublished whole newest": "b_run/version_0/checkpoint/ckpt_64_0.ckpt"}[tree]


def _steps(ckpt_dir: Path):
    return [int(e["step"]) for e in read_manifest(ckpt_dir)]


def test_torch_rundir_a_second_run_keeps_its_own_saves(tmp_path):
    """keep_last retention counts a run's own saves only: a second run of
    the same preset and seed with fewer steps keeps its newest 2 saves, and
    the first run's newest 2 stay too."""
    first = cli.run(PPO_TINY + [f"log_root={tmp_path}", "checkpoint.keep_last=2"])
    second = cli.run(PPO_TINY + [f"log_root={tmp_path}", "checkpoint.keep_last=2", "algo.total_steps=48"])
    a, b = Path(first["checkpoint"]).parent, Path(second["checkpoint"]).parent
    assert Path(second["checkpoint"]).exists() and Path(first["checkpoint"]).exists()
    assert _steps(b) == [32, 48] and sorted(p.name for p in b.glob("*.ckpt")) == ["ckpt_32_0.ckpt", "ckpt_48_0.ckpt"]
    assert _steps(a) == [48, 64] and a != b


def test_torch_rundir_a_rollback_stays_in_its_own_run(tmp_path):
    """The sentinel of a second run rolls back to that run's last complete
    checkpoint, not to the newest one of another run of the same preset."""
    cli.run(PPO_TINY + [f"log_root={tmp_path}"])
    second = cli.run(PPO_TINY + [f"log_root={tmp_path}", "fault.inject.nan_grads_at=[3]",
                                 "fault.sentinel.max_consecutive=1"])
    assert second["rollbacks"] == 1
    d = Path(second["checkpoint"]).parent
    good, rolled = load_checkpoint(d / "ckpt_32_0.ckpt"), load_checkpoint(d / "ckpt_48_0.ckpt")
    for k, v in good["agent"].items():
        assert torch.equal(rolled["agent"][k], v), k  # iteration 3 restarted from iteration 2's state
    assert rolled["iter_num"] == 3


def test_torch_rundir_resume_latest_resumes_the_newest_save(tmp_path):
    """A resume from an older step writes its saves into a directory of its
    own, so ``resume_from=latest`` afterwards resumes from that newest save,
    not from the higher step of the run it resumed from."""
    first = cli.run(PPO_TINY + [f"log_root={tmp_path}"])
    older = Path(first["checkpoint"]).parent / "ckpt_32_0.ckpt"
    branch = cli.run(["fabric.accelerator=cpu", f"checkpoint.resume_from={older}", "algo.total_steps=48",
                      f"log_root={tmp_path}"])
    assert branch["start_iter"] == 3 and Path(branch["checkpoint"]).name == "ckpt_48_0.ckpt"
    assert _steps(Path(first["checkpoint"]).parent) == [16, 32, 48, 64]  # the first run's saves untouched
    latest = cli.run(PPO_TINY[:1] + [f"log_root={tmp_path}", "checkpoint.resume_from=latest", "algo.total_steps=64",
                                     "fabric.accelerator=cpu", "seed=3"])
    assert latest["start_iter"] == 4  # after the branch's step 48


def test_torch_rundir_a_second_run_leaves_the_first_config(tmp_path):
    """The ``config.json`` that ``serve`` and ``evaluation`` read beside a
    run's checkpoints stays that run's own."""
    first = cli.run(PPO_TINY + [f"log_root={tmp_path}", "algo.total_steps=32"])
    before = find_run_config(first["checkpoint"]).read_text()
    cli.run(PPO_TINY + [f"log_root={tmp_path}", "algo.total_steps=32", "algo.update_epochs=2"])
    assert find_run_config(first["checkpoint"]).read_text() == before
    assert load_config(find_run_config(first["checkpoint"])).algo.update_epochs == 1
