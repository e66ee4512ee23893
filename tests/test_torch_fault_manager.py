"""The port's checkpoint manager and crash-safe checkpoint primitives
(``sheeprl_tpu_torch.fault.manager``, ``utils.checkpoint``,
``fault.inject``) against the JAX package's, on the CPU.

The same scenario runs through both: 7 saves with ``keep_last`` 3, a torn
newest checkpoint, a manifest entry whose digest does not match, a corrupt
manifest, and a resume from a scrambled checkpoint; both must keep the same
steps, find the same newest complete step at every stage and fall back to
the same older step. The rest holds the port's own contracts: the
asynchronous writer, orphan GC, typed load errors, the fault points,
``plant_torn_checkpoint`` and discovery across the port's run layout.
"""

import json
import os
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.fault import inject as jax_inject
from sheeprl_tpu.fault import manager as jax_manager
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.fault import manager
from sheeprl_tpu_torch.utils.checkpoint import (
    CheckpointError,
    find_run_config,
    finalize_host,
    load_checkpoint,
    save_checkpoint,
    stage_to_host,
)

STEPS = [8, 16, 24, 32, 40, 48, 56]


@pytest.fixture(autouse=True)
def _inject_isolation():
    inject.reset()
    jax_inject.reset()
    yield
    inject.reset()
    jax_inject.reset()


SIDES = {
    "jax": dict(
        mod=jax_manager, inject=jax_inject,
        state=lambda s: {"agent": {"w": jnp.full((3,), float(s))}, "iter_num": s},
        load=lambda p: jax_manager.load_resume_state(p),
        value=lambda st: float(np.asarray(st["agent"]["w"])[0]),
    ),
    "port": dict(
        mod=manager, inject=inject,
        state=lambda s: {"agent": {"w": torch.full((3,), float(s))}, "iter_num": s},
        load=lambda p: manager.load_resume_state(p),
        value=lambda st: float(st["agent"]["w"][0]),
    ),
}


def _scenario(side: str, d, async_save: bool) -> dict:
    """Run the manager scenario through one package; every outcome it sees."""
    s = SIDES[side]
    mod, inj = s["mod"], s["inject"]
    m = mod.CheckpointManager(keep_last=3, async_save=async_save)
    for step in STEPS:
        m.save(d / f"ckpt_{step}_0.ckpt", s["state"](step), step=step)
    m.close()
    out = {
        "manifest_steps": [e["step"] for e in mod.read_manifest(d)],
        "files": sorted(p.name for p in d.glob("*.ckpt")),
        "latest": mod.latest_complete(d).name,
    }
    inj.truncate_file(d / "ckpt_56_0.ckpt", keep_bytes=8)
    out["latest_after_torn"] = mod.latest_complete(d).name
    entries = mod.read_manifest(d)
    entries[1]["digest"] = "0" * 64  # step 48's record no longer matches its file
    (d / "manifest.json").write_text(json.dumps({"version": 1, "entries": entries}))
    out["complete_after_digest"] = [step for _, step, _ in mod.complete_entries(d)]
    out["latest_after_digest"] = mod.latest_complete(d).name
    (d / "manifest.json").write_bytes(b"\xff\xfe{ not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["manifest_after_corrupt"] = mod.read_manifest(d)
        out["latest_after_corrupt"] = mod.latest_complete(d).name
    out["warned_corrupt"] = any("corrupted checkpoint manifest" in str(w.message) for w in caught)
    inj.scramble_file(d / "ckpt_48_0.ckpt", seed=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = s["load"](d / "ckpt_48_0.ckpt")
        out["fallback_from_48"] = (state["iter_num"], s["value"](state))
        state = s["load"](d / "ckpt_56_0.ckpt")
        out["fallback_from_56"] = (state["iter_num"], s["value"](state))
    out["warned_fallback"] = sum("resuming from older complete entry" in str(w.message) for w in caught)
    return out


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_torch_fault_manager_scenario_matches_jax(tmp_path, async_save):
    want = _scenario("jax", tmp_path / "jax", async_save)
    got = _scenario("port", tmp_path / "port", async_save)
    assert got == want
    assert got["manifest_steps"] == [40, 48, 56]
    assert got["latest_after_torn"] == got["latest_after_corrupt"] == "ckpt_48_0.ckpt"
    assert got["fallback_from_48"] == got["fallback_from_56"] == (40, 40.0)


def _tiny(value: float, iter_num: int = 1) -> dict:
    return {"agent": {"w": torch.full((3,), value), "b": torch.zeros(2)}, "iter_num": iter_num}


def test_torch_fault_manager_manifest_records_completed_saves(tmp_path):
    m = manager.CheckpointManager()
    for step in (8, 16):
        m.save(tmp_path / f"ckpt_{step}_0.ckpt", _tiny(step), step=step, config={"seed": 1})
    m.close()
    entries = manager.read_manifest(tmp_path)
    assert [e["step"] for e in entries] == [8, 16]
    for e in entries:
        path = tmp_path / e["file"]
        assert e["format_version"] == manager.FORMAT_VERSION and e["time"] > 0 and e["has_rb"] is False
        assert e["bytes"] == path.stat().st_size and e["digest"] == manager._digest(path)
    assert json.loads((tmp_path / "config.json").read_text()) == {"seed": 1}
    assert [t["step"] for t in m.timings] == [8, 16]
    assert all(t["bytes"] > 0 and t["digest_s"] >= 0 and t["blocked_s"] >= t["write_s"] for t in m.timings)


def test_torch_fault_manager_keep_last_and_orphan_gc(tmp_path):
    stale = time.time() - 3600
    for name in ("ckpt_99_0.ckpt.tmp", "ckpt_3_0.ckpt.tmp"):
        (tmp_path / name).write_bytes(b"torn")
    os.utime(tmp_path / "ckpt_99_0.ckpt.tmp", (stale, stale))  # old: a dead save's; the fresh one may be in flight
    save_checkpoint(tmp_path / "ckpt_4_0.ckpt", _tiny(4.0))  # a bare file from before the manifest
    m = manager.CheckpointManager(keep_last=2)
    for step in (8, 16, 24, 32, 40):
        m.save(tmp_path / f"ckpt_{step}_0.ckpt", _tiny(step), step=step)
    m.close()
    assert [e["step"] for e in manager.read_manifest(tmp_path)] == [32, 40]
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == ["ckpt_32_0.ckpt", "ckpt_40_0.ckpt"]
    assert [p.name for p in tmp_path.glob("*.tmp")] == ["ckpt_3_0.ckpt.tmp"]


def test_torch_fault_manager_async_snapshot_and_error_surfacing(tmp_path):
    m = manager.CheckpointManager(keep_last=3, async_save=True)
    live = _tiny(8.0, 8)
    m.save(tmp_path / "ckpt_8_0.ckpt", live, step=8)
    live["agent"]["w"].fill_(7.0)  # after save returns, the live state may change
    m.save(tmp_path / "ckpt_16_0.ckpt", _tiny(16.0, 16), step=16)  # waits for the first: one in flight
    m.close()
    assert [e["step"] for e in manager.read_manifest(tmp_path)] == [8, 16]
    assert torch.equal(load_checkpoint(tmp_path / "ckpt_8_0.ckpt")["agent"]["w"], torch.full((3,), 8.0))

    inject.arm("checkpoint.staged", action="raise", at=1)
    m2 = manager.CheckpointManager(async_save=True)
    with pytest.warns(UserWarning, match="FAILED"):
        m2.save(tmp_path / "ckpt_24_0.ckpt", _tiny(24.0, 24), step=24)
        m2.wait()
    with pytest.raises(CheckpointError, match="Asynchronous checkpoint save failed"):
        m2.close()
    assert not (tmp_path / "ckpt_24_0.ckpt").exists() and not (tmp_path / "ckpt_24_0.ckpt.tmp").exists()
    assert manager.latest_complete(tmp_path).name == "ckpt_16_0.ckpt"


@pytest.mark.parametrize("point", ["checkpoint.staged", "checkpoint.pre_commit", "checkpoint.post_commit"])
def test_torch_fault_manager_fault_points_leave_a_complete_checkpoint(tmp_path, point):
    """A fault at each point: before the commit the new step never appears
    and the previous one stays whole; after it the new file is whole but
    unpublished, which the scan still finds."""
    m = manager.CheckpointManager()
    m.save(tmp_path / "ckpt_8_0.ckpt", _tiny(8.0, 8), step=8)
    inject.arm(point, action="raise", at=1)
    with pytest.raises(inject.FaultInjected):
        m.save(tmp_path / "ckpt_16_0.ckpt", _tiny(16.0, 16), step=16)
    assert [e["step"] for e in manager.read_manifest(tmp_path)] == [8]
    committed = point == "checkpoint.post_commit"
    assert (tmp_path / "ckpt_16_0.ckpt").exists() == committed
    assert manager.latest_complete(tmp_path).name == ("ckpt_16_0.ckpt" if committed else "ckpt_8_0.ckpt")
    assert load_checkpoint(manager.latest_complete(tmp_path))["iter_num"] == (16 if committed else 8)


@pytest.mark.parametrize("damage", ["missing", "truncated", "scrambled", "not-a-dict"])
def test_torch_fault_load_checkpoint_raises_checkpoint_error(tmp_path, damage):
    path = save_checkpoint(tmp_path / "ckpt_8_0.ckpt", _tiny(1.0))
    if damage == "missing":
        path.unlink()
    elif damage == "truncated":
        inject.truncate_file(path, keep_bytes=64)
    elif damage == "scrambled":
        inject.scramble_file(path)
    else:
        torch.save(torch.ones(2), path)
    with pytest.raises(CheckpointError) as err:
        load_checkpoint(path)
    assert err.value.path == path


def test_torch_fault_plant_torn_checkpoint_is_complete_but_unloadable(tmp_path):
    m = manager.CheckpointManager()
    m.save(tmp_path / "ckpt_8_0.ckpt", _tiny(8.0, 8), step=8)
    torn = inject.plant_torn_checkpoint(tmp_path, "ckpt_16_0.ckpt", _tiny(16.0, 16))
    assert manager.latest_complete(tmp_path) == torn  # digest and size match the manifest
    assert [e["step"] for e in manager.read_manifest(tmp_path)] == [8, 16]
    with pytest.raises(CheckpointError):
        load_checkpoint(torn)
    with pytest.warns(UserWarning, match="resuming from older complete entry"):
        assert manager.load_resume_state(torn)["iter_num"] == 8
    assert not list(tmp_path.parent.glob("torn_staging_*"))


def test_torch_fault_find_latest_run_checkpoint_across_layouts(tmp_path):
    a = tmp_path / "seed_1" / "checkpoint"  # the port's run layout
    b = tmp_path / "seed_2" / "checkpoint"
    c = tmp_path / "run" / "version_0" / "checkpoint"  # the JAX package's
    for d, steps in ((a, (8, 16)), (b, (8,)), (c, (4,))):
        m = manager.CheckpointManager()
        for step in steps:
            m.save(d / f"ckpt_{step}_0.ckpt", _tiny(step), step=step)
        m.close()
    assert manager.find_latest_run_checkpoint(tmp_path) == c / "ckpt_4_0.ckpt"  # newest by wall time
    inject.truncate_file(c / "ckpt_4_0.ckpt")
    assert manager.find_latest_run_checkpoint(tmp_path) == b / "ckpt_8_0.ckpt"
    assert manager.find_latest_run_checkpoint(a) == a / "ckpt_16_0.ckpt"
    assert manager.find_latest_run_checkpoint(tmp_path / "absent") is None


def test_torch_fault_find_run_config_through_the_manifest_anchor(tmp_path):
    ckpt_dir = tmp_path / "run" / "checkpoint"
    m = manager.CheckpointManager()
    m.save(ckpt_dir / "ckpt_8_0.ckpt", _tiny(8.0), step=8, config={"seed": 3})
    deep = ckpt_dir / "a" / "b" / "c" / "d" / "ckpt_8_0.ckpt"
    deep.parent.mkdir(parents=True)
    deep.write_bytes((ckpt_dir / "ckpt_8_0.ckpt").read_bytes())
    assert find_run_config(deep) == ckpt_dir / "config.json"
    with pytest.raises(CheckpointError, match="searched"):
        find_run_config(tmp_path / "elsewhere" / "ckpt_1_0.ckpt")


def test_torch_fault_stage_to_host_on_the_cpu(tmp_path):
    live = _tiny(2.0)
    staged = stage_to_host(live, copy_host=True)
    live["agent"]["w"].fill_(5.0)
    host = finalize_host(staged)
    assert torch.equal(host["agent"]["w"], torch.full((3,), 2.0)) and host["iter_num"] == 1
    shared = finalize_host(stage_to_host(live))
    assert shared["agent"]["w"].data_ptr() == live["agent"]["w"].data_ptr()  # a synchronous save needs no copy


def test_torch_fault_env_variables_arm_points(monkeypatch):
    monkeypatch.setenv(inject.ARM_ENV_VAR, "checkpoint.staged:raise:2")
    assert inject.arm_from_env() == 1
    inject.fault_point("checkpoint.staged")
    with pytest.raises(inject.FaultInjected, match="hit 2"):
        inject.fault_point("checkpoint.staged")
    monkeypatch.setenv(inject.NAN_ENV_VAR, "2,5")
    nan = inject.NaNInjector({"fault": {"inject": {"nan_grads_at": [7]}}})
    assert nan.at == frozenset({2, 5, 7}) and nan.fires(5) and not nan.fires(3)
    data = {"advantages": torch.ones(4, 1), "other": torch.ones(2)}
    nan.poison(data, "advantages", 7)
    assert torch.isnan(data["advantages"]).all() and data["advantages"].shape == (4, 1) and nan.fired == 1
    want = jax_inject.NaNInjector({"fault": {"inject": {"nan_grads_at": [7]}}})
    assert want.at == nan.at


def test_torch_fault_find_run_config_reads_nothing_above_the_run(tmp_path):
    """The manifest anchor is looked for up to the nearest ``checkpoint``
    directory, else in the four nearest ancestors: a manifest and a config
    further up belong to no run of this checkpoint and are not read."""
    outer = tmp_path / "outer"
    m = manager.CheckpointManager()
    m.save(outer / "ckpt_8_0.ckpt", _tiny(8.0), step=8, config={"seed": 3})
    deep = outer / "a" / "b" / "c" / "d" / "ckpt_8_0.ckpt"
    deep.parent.mkdir(parents=True)
    deep.write_bytes((outer / "ckpt_8_0.ckpt").read_bytes())
    with pytest.raises(CheckpointError, match="searched") as err:
        find_run_config(deep)
    assert str(outer / "config.json") not in str(err.value)
