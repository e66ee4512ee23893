"""The port's PPO loop through ``cli.run`` on the CPU (``fabric.accelerator=cpu``):
the preset is the JAX package's ``exp=ppo`` composition, a few iterations
train with the plain GAE (the CUDA kernel's launch count stays 0), a
checkpoint carries the JAX keys and resumes with its counters going on,
the truncation bootstrap ``r += gamma * V(final obs)`` reaches the rewards
GAE sees, and ``run`` still dispatches the DreamerV3 preset to its own
loop."""

import importlib

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

ppo_module = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo")

SMALL = ["preset=ppo", "fabric.accelerator=cpu", "metric.log_level=0", "algo.run_test=false"]


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


def test_torch_ppo_loop_preset_is_the_jax_exp_ppo():
    """Every key of the port's preset holds the value the JAX composition
    gives it (the optimizer's target names the builder by its last
    component), but ``buffer.memmap``: memmap storage is not ported."""
    jax_cfg = compose(["exp=ppo"])
    port = preset("ppo")
    checked = 0
    for path, value in _leaves(port):
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
    assert port["buffer"]["size"] == port["algo"]["rollout_steps"]


def test_torch_ppo_loop_trains_checkpoints_and_resumes(tmp_path):
    K.reset_launches()
    first = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=1536"])
    assert first["device"] == "cpu" and first["iterations"] == 3 and first["policy_steps"] == 1536
    assert len(first["losses"]) == 3 and np.isfinite(np.asarray(first["losses"])).all()
    assert len(first["rollout_s"]) == len(first["gae_s"]) == len(first["update_s"]) == 3
    assert first["episodes"] and all(ret == length for _, _, ret, length in first["episodes"])  # +1 per step
    assert K.LAUNCHES["gae"] == 0  # CPU tensors take the plain version
    state = load_checkpoint(first["checkpoint"])
    assert set(state) == {"agent", "optimizer", "iter_num", "batch_size", "last_log", "last_checkpoint", "train_step",
                          "last_train", "rng"}
    assert state["iter_num"] == 3 and state["batch_size"] == 64 and state["last_checkpoint"] == 1536
    assert first["checkpoint"].endswith("ckpt_1536_0.ckpt")

    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", "algo.total_steps=2560", f"log_root={tmp_path}"])
    assert resumed["start_iter"] == 4 and resumed["iterations"] == 2 and resumed["policy_steps"] == 2560
    assert resumed["test_reward"] is None  # the checkpoint's config keeps run_test off
    after = load_checkpoint(resumed["checkpoint"])
    assert after["iter_num"] == 5
    assert {int(s["step"]) for s in after["optimizer"]["state"].values()} == {5 * 10 * 8}
    assert not torch.equal(after["agent"]["critic.out.weight"], state["agent"]["critic.out.weight"])


def test_torch_ppo_loop_truncation_bootstrap_reaches_gae(tmp_path, monkeypatch):
    """With a 10-step time limit every episode of a fresh policy is cut: the
    reward of each cut step is 1 + gamma * V(final obs), the value the player
    gave for it, and every other step's reward stays 1."""
    seen = {"gae": [], "values": []}
    real_gae, real_build = ppo_module.gae, ppo_module.build_agent

    def spy_gae(rewards, values, dones, next_value, gamma, lam):
        seen["gae"].append((rewards.clone(), dones.clone(), len(seen["values"])))
        return real_gae(rewards, values, dones, next_value, gamma, lam)

    def spy_build(*args, **kwargs):
        agent, player = real_build(*args, **kwargs)
        get_values = player.get_values

        def recorded(obs):
            out = get_values(obs)
            seen["values"].append(out.clone())
            return out

        player.get_values = recorded
        return agent, player

    monkeypatch.setattr(ppo_module, "gae", spy_gae)
    monkeypatch.setattr(ppo_module, "build_agent", spy_build)
    summary = cli.run(SMALL + [
        f"log_root={tmp_path}", "env.num_envs=2", "env.max_episode_steps=10", "algo.rollout_steps=25",
        "buffer.size=25", "algo.per_rank_batch_size=25", "algo.update_epochs=1", "algo.total_steps=100",
    ])
    assert summary["iterations"] == 2
    start = 0
    cut = 0
    for rewards, dones, n_values in seen["gae"]:
        truncation_values = torch.cat(seen["values"][start:n_values - 1]).reshape(-1)  # the last is the bootstrap
        start = n_values
        bootstrapped = rewards.reshape(-1) != 1.0
        assert torch.all(dones.reshape(-1)[bootstrapped] == 1)
        expected = (1.0 + np.float32(0.99) * truncation_values.numpy()).astype(np.float32)
        np.testing.assert_array_equal(rewards.reshape(-1)[bootstrapped].numpy(), expected)
        cut += int(bootstrapped.sum())
    assert cut >= 8  # both envs cut at least twice per 25-step rollout


def test_torch_ppo_loop_run_dispatches_on_the_algorithm(monkeypatch):
    dreamer = importlib.import_module("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3")
    monkeypatch.setattr(dreamer, "main", lambda cfg, device: {"algo": cfg.algo.name, "device": str(device)})
    monkeypatch.setattr(ppo_module, "main", lambda cfg, device: {"algo": cfg.algo.name, "device": str(device)})
    assert cli.run(["preset=dreamer_v3_100k_atari_dummy", "fabric.accelerator=cpu"]) == {"algo": "dreamer_v3", "device": "cpu"}
    assert cli.run(["preset=ppo", "fabric.accelerator=cpu"]) == {"algo": "ppo", "device": "cpu"}
    for name in ("a2c", "ppo_recurrent", "droq", "sac_ae"):  # trainers since slices 12 and 13
        module = importlib.import_module(f"sheeprl_tpu_torch.algos.{name}.{name}")
        monkeypatch.setattr(module, "main", lambda cfg, device: {"algo": cfg.algo.name, "device": str(device)})
        assert cli.run([f"preset={name}", "fabric.accelerator=cpu"]) == {"algo": name, "device": "cpu"}
    v2 = importlib.import_module("sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2")  # a trainer since slice 15
    monkeypatch.setattr(v2, "main", lambda cfg, device: {"algo": cfg.algo.name, "device": str(device)})
    assert cli.run(["preset=dreamer_v2_atari_dummy", "fabric.accelerator=cpu"]) == {"algo": "dreamer_v2", "device": "cpu"}
    anakin = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo_anakin")  # trainers since slice 17
    population = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo_anakin_population")
    for name, module in (("ppo_anakin", anakin), ("ppo_anakin_population", population)):
        monkeypatch.setattr(module, "main", lambda cfg, device: {"algo": cfg.algo.name, "device": str(device)})
        assert cli.run([f"preset={name}", "fabric.accelerator=cpu"]) == {"algo": name, "device": "cpu"}
    # every JAX trainer is ported: an unregistered name raises JAX's error
    with pytest.raises(RuntimeError, match="Given the algorithm named 'no_such_algo', no module has been found"):
        cli.run(["preset=ppo", "fabric.accelerator=cpu", "algo.name=no_such_algo"])


def test_torch_ppo_loop_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["preset=ppo"])
