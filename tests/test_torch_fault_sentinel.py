"""The port's divergence sentinel against the JAX package's, on the CPU: the
same ``observe`` sequences trip at the same iterations with the same
counters, and ``recover`` gives the same outcome and message for each
action (warn, rollback from a checkpoint, rollback without one, abort).
Then the sentinel end to end through the port's PPO loop on CartPole:
``fault.inject.nan_grads_at`` skips every minibatch of that iteration and keeps
the parameters finite; ``action=rollback`` restores the latest complete
checkpoint exactly; ``action=abort`` raises ``DivergenceError``.
"""

import warnings

import jax.numpy as jnp
import pytest
import torch

from sheeprl_tpu.fault import DivergenceError as JaxDivergenceError
from sheeprl_tpu.fault import DivergenceSentinel as JaxSentinel
from sheeprl_tpu.fault.manager import CheckpointManager as JaxManager
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceError, DivergenceSentinel, find_latest_run_checkpoint
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

SEQUENCES = {
    "blip": [0, 1, 0, 0, 2, 0],
    "streak-of-three": [0, 1, 2, 80, 0],
    "long-streak": [5, 5, 5, 5, 5],
    "clean": [0, 0, 0],
}


def _observe(sentinel, seq):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trips = [sentinel.observe(b) for b in seq]
    return trips, [str(w.message) for w in caught], sentinel.consecutive, sentinel.total_skipped


@pytest.mark.parametrize("max_consecutive", [1, 2, 3])
@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_torch_fault_sentinel_observe_matches_jax(seq, enabled, max_consecutive):
    cfg = {"enabled": enabled, "max_consecutive": max_consecutive, "action": "warn"}
    got = _observe(DivergenceSentinel(cfg), SEQUENCES[seq])
    want = _observe(JaxSentinel(cfg), SEQUENCES[seq])
    assert got == want
    assert DivergenceSentinel(cfg).observe(torch.tensor(2.0)) == JaxSentinel(cfg).observe(jnp.float32(2.0))


def _recover(sentinel, ckpt_dir):
    restored = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sentinel.observe(3)
        try:
            sentinel.recover(ckpt_dir, restored.update)
            outcome = "continued"
        except (DivergenceError, JaxDivergenceError) as e:
            outcome = str(e)
    messages = [str(w.message).replace(str(ckpt_dir), "<dir>") for w in caught]
    return outcome, messages, restored.get("iter_num"), sentinel.rollbacks, sentinel.consecutive


@pytest.mark.parametrize("checkpointed", [True, False], ids=["with-checkpoint", "without-checkpoint"])
@pytest.mark.parametrize("action", ["warn", "rollback", "abort"])
def test_torch_fault_sentinel_recover_matches_jax(tmp_path, action, checkpointed):
    cfg = {"enabled": True, "max_consecutive": 1, "action": action}
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    if checkpointed:
        CheckpointManager().save(port_dir / "ckpt_8_0.ckpt", {"agent": {"w": torch.ones(2)}, "iter_num": 4}, step=8)
        JaxManager().save(jax_dir / "ckpt_8_0.ckpt", {"agent": {"w": jnp.ones(2)}, "iter_num": 4}, step=8)
    got = _recover(DivergenceSentinel(cfg), port_dir)
    want = _recover(JaxSentinel(cfg), jax_dir)
    assert got == want
    if action == "rollback" and checkpointed:
        assert got[0] == "continued" and got[2] == 4 and got[3] == 1


def test_torch_fault_sentinel_rejects_an_unknown_action():
    with pytest.raises(ValueError, match="rollback\\|abort\\|warn"):
        DivergenceSentinel({"action": "retry"})


# -- end to end through the port's PPO loop -----------------------------------
def _ppo(tmp_path, *extra):
    return cli.run([
        "preset=ppo", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=16", "buffer.size=16",
        "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.total_steps=160", "checkpoint.every=32",
        "metric.log_level=0", "algo.run_test=false", f"log_root={tmp_path}", "seed=7", *extra,
    ])


def test_torch_fault_sentinel_ppo_run_skips_the_poisoned_iteration(tmp_path):
    with pytest.warns(UserWarning, match="8 optimizer update\\(s\\) skipped"):
        s = _ppo(tmp_path, "fault.inject.nan_grads_at=[3]")
    assert s["skipped"] == [0.0, 0.0, 8.0, 0.0, 0.0] and s["Fault/skipped_updates"] == 8.0
    assert s["rollbacks"] == 0 and s["iterations"] == 5
    state = load_checkpoint(s["checkpoint"])
    assert all(torch.isfinite(v).all() for v in state["agent"].values())
    assert {int(st["step"]) for st in state["optimizer"]["state"].values()} == {4 * 8}  # 4 iterations taken


def test_torch_fault_sentinel_ppo_run_rolls_back_to_the_last_checkpoint(tmp_path):
    """Iteration 3 is poisoned with max_consecutive 1: the sentinel loads the
    iteration-2 checkpoint (step 64), so the iteration-3 checkpoint holds
    exactly its agent and optimizer."""
    with pytest.warns(UserWarning, match="rolling back to last good checkpoint"):
        s = _ppo(tmp_path, "fault.inject.nan_grads_at=[3]", "fault.sentinel.max_consecutive=1",
                 "checkpoint.every=16")
    assert s["rollbacks"] == 1
    ckpt_dir = find_latest_run_checkpoint(tmp_path / "ppo" / "CartPole-v1").parent
    good, after = load_checkpoint(ckpt_dir / "ckpt_64_0.ckpt"), load_checkpoint(ckpt_dir / "ckpt_96_0.ckpt")
    for k, v in good["agent"].items():
        assert torch.equal(after["agent"][k], v), k
    for i, st in good["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(after["optimizer"]["state"][i][k], v), (i, k)
    assert torch.equal(after["rng"], good["rng"])


def test_torch_fault_sentinel_ppo_run_aborts(tmp_path):
    with pytest.raises(DivergenceError, match="diverged.*abort"):
        with pytest.warns(UserWarning, match="skipped"):
            _ppo(tmp_path, "fault.inject.nan_grads_at=[1,2,3]", "fault.sentinel.max_consecutive=2",
                 "fault.sentinel.action=abort")


def test_torch_fault_sentinel_off_runs_unguarded(tmp_path):
    """``fault.sentinel.enabled=false``: no guard, so a poisoned iteration's
    NaNs reach the parameters, as they did before the guard existed."""
    s = _ppo(tmp_path, "fault.inject.nan_grads_at=[5]", "fault.sentinel.enabled=false")
    assert s["skipped"] == [] and s["Fault/skipped_updates"] == 0.0
    state = load_checkpoint(s["checkpoint"])
    assert not all(torch.isfinite(v).all() for v in state["agent"].values())
