"""The port's SAC loop through ``cli.run`` on the CPU (``fabric.accelerator=cpu``),
at a tiny size (hidden 32, batch 16, 2 envs).

- the ``sac`` and ``sac_per`` presets are the JAX package's ``exp=sac``
  composition with the overrides each names (Pendulum-v1; the device ring
  and PER for ``sac_per``), key for key;
- ``run preset=sac_per`` trains on the device-resident ring with PER (the
  plain ``sumtree_sample`` on CPU tensors: no kernel launch), checkpoints
  the ring, its sum-tree, ``max_p`` and the draw generator, and resumes
  from them with its counters going on;
- ``run preset=sac`` trains on the host buffer and resumes from it;
- either checkpoint resumes on the other tier (the crossovers);
- the transition of a truncated env stores its final observation as the
  next observation, not the reset one;
- ``run`` dispatches ``algo.name=sac`` to the SAC loop.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.envs import PendulumEnv
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.replay import DeviceReplayState
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

sac_module = importlib.import_module("sheeprl_tpu_torch.algos.sac.sac")

TINY = [
    "fabric.accelerator=cpu", "metric.log_level=0", "algo.run_test=false", "env.num_envs=2", "buffer.size=1024",
    "algo.hidden_size=32", "algo.actor.hidden_size=32", "algo.critic.hidden_size=32", "algo.per_rank_batch_size=16",
    "algo.learning_starts=32", "checkpoint.every=0", "checkpoint.save_last=true",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", ["sac", "sac_per"])
def test_torch_sac_loop_presets_are_the_jax_exp_sac(name):
    """Every key of the preset holds the value the JAX composition with the
    preset's overrides gives it (the optimizer's target by its last
    component), but ``buffer.memmap``: memmap storage is not ported."""
    port = preset(name)
    assert port.preset.composition == "exp=sac"
    jax_cfg = compose(["exp=sac"] + list(port.preset.overrides))
    checked = 0
    for path, value in _leaves(port):
        if path.startswith("preset."):
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        if path == "buffer.memmap":
            assert node is True and value is False
        elif path.endswith("_target_"):
            assert str(node).rsplit(".", 1)[-1] == value, path
        elif isinstance(value, float):
            assert float(node) == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 40
    assert port.buffer.device_resident is (name == "sac_per") and port.buffer.priority.enabled is (name == "sac_per")
    assert port.env.id == "Pendulum-v1" and port.buffer.size == 1_000_000 and port.algo.per_rank_batch_size == 256


def _run(name, tmp_path, *extra):
    return cli.run([f"preset={name}", f"log_root={tmp_path}"] + TINY + list(extra))


def test_torch_sac_loop_per_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    K.reset_launches()
    s = _run("sac_per", tmp_path, "algo.total_steps=160")
    assert s["resident"] and s["prioritized"] and s["device"] == "cpu"
    assert s["iterations"] == 80 and s["policy_steps"] == 160
    # the first grant replays the warm-up backlog: more gradient steps than dispatches
    assert s["gradient_steps"] > s["train_calls"] > 0 and len(s["losses"]) == s["train_calls"]
    assert np.isfinite(np.asarray(s["losses"])).all() and s["replay"]["Replay/size"] == 160
    assert K.LAUNCHES["sumtree_sample"] == 0  # CPU tensors take the plain version

    saved = load_checkpoint(s["checkpoint"])
    ring = DeviceReplayState.from_dict(saved["rb"])
    assert ring.meta["host_pos"] == 80 and float(ring.arrays["max_p"]) > 1.0
    tree = ring.arrays["tree"]
    assert float(tree[1]) == pytest.approx(float(tree[tree.shape[0] // 2 :].sum()), rel=1e-5)

    seen = {}
    real_load = sac_module.DeviceReplayBuffer.load_state_dict

    def spy(self, snap):
        out = real_load(self, snap)
        seen.update(tree=self.tree.clone(), max_p=float(self.max_p), pos=self.pos,
                    obs=self.storage["observations"].clone(), key=self.generator.get_state())
        return out

    monkeypatch.setattr(sac_module.DeviceReplayBuffer, "load_state_dict", spy)
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=320", f"log_root={tmp_path}"])
    assert torch.equal(seen["tree"], tree) and seen["max_p"] == float(ring.arrays["max_p"]) and seen["pos"] == 80
    assert torch.equal(seen["obs"], ring.arrays["storage/observations"]) and torch.equal(seen["key"], ring.arrays["key"])
    assert r["start_iter"] == 81 and r["iterations"] == 80 and r["policy_steps"] == 320
    assert r["gradient_steps"] > 0 and r["resident"] and r["replay"]["Replay/size"] == 320


def test_torch_sac_loop_host_tier_trains_checkpoints_and_resumes(tmp_path):
    s = _run("sac", tmp_path, "algo.total_steps=160")
    assert not s["resident"] and s["replay"] is None and s["gradient_steps"] > s["train_calls"] > 0
    assert np.isfinite(np.asarray(s["losses"])).all()
    saved = load_checkpoint(s["checkpoint"])
    assert saved["rb"]["pos"] == 80 and set(saved["rb"]["buffer"]) >= set(sac_module.RING_KEYS) | {"truncated"}
    assert set(saved) >= {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "ratio", "rng", "iter_num"}
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=320", f"log_root={tmp_path}"])
    assert r["start_iter"] == 81 and r["policy_steps"] == 320 and r["gradient_steps"] > 0


def test_torch_sac_loop_checkpoints_cross_between_the_tiers(tmp_path, monkeypatch):
    per = _run("sac_per", tmp_path / "per", "algo.total_steps=80")
    host = _run("sac", tmp_path / "host", "algo.total_steps=80")
    loaded = {}
    real_host = sac_module.DeviceReplayBuffer.load_host_buffer

    def spy(self, rb):
        loaded["rows"] = rb.pos
        return real_host(self, rb)

    monkeypatch.setattr(sac_module.DeviceReplayBuffer, "load_host_buffer", spy)
    onto_host = cli.run([f"checkpoint.resume_from={per['checkpoint']}", "algo.total_steps=160",
                         "buffer.device_resident=false", f"log_root={tmp_path}"])
    assert not onto_host["resident"] and onto_host["gradient_steps"] > 0
    onto_ring = cli.run([f"checkpoint.resume_from={host['checkpoint']}", "algo.total_steps=160",
                         "buffer.device_resident=true", "buffer.priority.enabled=true", f"log_root={tmp_path}"])
    assert onto_ring["resident"] and onto_ring["prioritized"] and loaded["rows"] == 40
    assert onto_ring["replay"]["Replay/size"] == 160


def test_torch_sac_loop_refuses_a_prioritized_ring_over_its_budget(tmp_path):
    """The host buffer samples uniformly: a PER ring that does not fit the
    budget stops the run instead of training another algorithm."""
    with pytest.raises(ValueError, match="buffer.hbm_budget_gb=1e-09.*no PER"):
        _run("sac_per", tmp_path, "algo.total_steps=80", "buffer.hbm_budget_gb=1e-9")
    uniform = _run("sac_per", tmp_path, "algo.total_steps=80", "buffer.hbm_budget_gb=1e-9", "buffer.priority.enabled=false")
    assert not uniform["resident"] and not uniform["prioritized"] and uniform["gradient_steps"] > 0


def test_torch_sac_loop_stores_the_final_observation_of_a_truncated_env(tmp_path, monkeypatch):
    """Pendulum truncates after 200 steps: that row's next observation is
    one Pendulum step from its observation under its action, and the next
    row starts from the reset observation."""
    rings = []
    real = sac_module.make_resident_train_step

    def keep(agent, optimizers, cfg, drb, **kwargs):
        rings.append(drb)
        return real(agent, optimizers, cfg, drb, **kwargs)

    monkeypatch.setattr(sac_module, "make_resident_train_step", keep)
    _run("sac_per", tmp_path, "algo.total_steps=420", "algo.learning_starts=400", "checkpoint.save_last=false")
    (drb,) = rings
    obs, nxt, act = (drb.storage[k][:, 0].numpy() for k in ("observations", "next_observations", "actions"))
    env = PendulumEnv()
    for t in (150, 199):  # inside the episode, and its last step
        env.reset()
        env.state = np.array([math.atan2(float(obs[t, 1]), float(obs[t, 0])), float(obs[t, 2])])
        np.testing.assert_allclose(env.step(act[t])[0]["state"], nxt[t], atol=1e-5)
    np.testing.assert_array_equal(nxt[150], obs[151])
    assert not np.allclose(nxt[199], obs[200], atol=1e-3)  # obs[200] is the reset observation
    assert drb.storage["terminated"].sum() == 0


def test_torch_sac_loop_run_dispatches_on_the_algorithm(monkeypatch):
    called = {}
    monkeypatch.setattr(sac_module, "main", lambda cfg, device: called.setdefault("sac", (cfg.algo.name, str(device))))
    cli.run(["preset=sac_per", "fabric.accelerator=cpu"])
    assert called == {"sac": ("sac", "cpu")}


def test_torch_sac_loop_refuses_what_it_cannot_run(tmp_path):
    # buffer.sample_next_obs runs on the host buffer; the prioritized ring needs stored next observations
    with pytest.raises(ValueError, match="sample_next_obs"):
        _run("sac_per", tmp_path, "buffer.sample_next_obs=true", "algo.total_steps=40")
    with pytest.raises(ValueError, match="continuous"):
        _run("sac", tmp_path, "env.id=CartPole-v1")
