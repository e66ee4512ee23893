"""The port's single-run Anakin loop (``ppo_anakin``) through ``cli.run`` on
the CPU (``fabric.accelerator=cpu``): the preset is the JAX package's
``exp=ppo_anakin`` composition; a run trains in blocks with one read of its
metrics per block, checkpoints with the JAX loop's keys and both generators,
resumes with its counters going on, evaluates and serves its checkpoint;
``dry_run``, the population trigger, the sweep-ignored warning, the
registry's 17 trainers, and the refusal of an env with no device twin."""

import importlib

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

anakin = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo_anakin")

SMALL = ["preset=ppo_anakin", "fabric.accelerator=cpu", "metric.log_level=0", "env.num_envs=2",
         "algo.rollout_steps=32", "algo.update_epochs=2", "algo.per_rank_batch_size=32"]


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


@pytest.mark.parametrize("name", ["ppo_anakin", "ppo_anakin_population"])
def test_torch_anakin_loop_presets_are_the_jax_exps(name):
    """Every key of the port's preset holds the value the JAX composition
    gives it, but ``buffer.memmap`` (the Anakin loops keep no buffer) and the
    preset's own notes."""
    jax_cfg = compose([f"exp={name}"])
    checked = 0
    for path, value in _leaves(preset(name)):
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
        elif isinstance(value, list) and value and isinstance(value[0], float):
            assert [float(v) for v in node] == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 50


def test_torch_anakin_loop_trains_in_blocks_with_one_read_each(tmp_path, monkeypatch):
    reads = []
    real = anakin.read_block

    def counted(metrics):
        reads.append(sorted(metrics))
        return real(metrics)

    monkeypatch.setattr(anakin, "read_block", counted)
    K.reset_launches()
    summary = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=640", "algo.iters_per_block=4",
                               "algo.run_test=false"])
    assert summary["iterations"] == 10 and summary["blocks"] == 3 and summary["iters_per_block"] == 4
    assert len(reads) == 3 and reads[0] == ["bad", "ent", "ep_done", "ep_len", "ep_ret", "pg", "v"]
    assert len(summary["losses"]) == 10 and np.isfinite(np.asarray(summary["losses"])).all()
    assert summary["skipped"] == [0.0] * 10
    assert summary["episodes"] and all(ret == length for _, _, ret, length in summary["episodes"])  # +1 a step
    assert K.LAUNCHES["gae"] == 0  # CPU tensors take the plain version


def test_torch_anakin_loop_checkpoints_resumes_and_evaluates(tmp_path):
    first = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=384", "checkpoint.every=128"])
    assert first["iterations"] == 6 and first["policy_steps"] == 384 and first["test_reward"] is not None
    state = load_checkpoint(first["checkpoint"])
    assert set(state) == {"agent", "optimizer", "scheduler", "iter_num", "batch_size", "last_log", "last_checkpoint",
                          "train_step", "last_train", "rng", "rollout_rng"}
    assert state["iter_num"] == 6 and state["last_checkpoint"] == 384 and state["train_step"] == 6
    assert first["checkpoint"].endswith("ckpt_384_0.ckpt")

    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "algo.total_steps=512", f"log_root={tmp_path}", "algo.run_test=false"])
    assert resumed["start_iter"] == 7 and resumed["iterations"] == 2 and resumed["policy_steps"] == 512
    after = load_checkpoint(resumed["checkpoint"])
    assert after["iter_num"] == 8 and after["train_step"] == 8
    assert {int(s["step"]) for s in after["optimizer"]["state"].values()} == {8 * 2 * 2}
    assert not torch.equal(after["agent"]["critic.out.weight"], state["agent"]["critic.out.weight"])

    evaluated = cli.evaluation([f"checkpoint_path={first['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["reward"] == first["test_reward"]  # the run's own greedy test, same weights and seed


def test_torch_anakin_loop_serves_its_checkpoint(tmp_path):
    from sheeprl_tpu_torch.config import load_config
    from sheeprl_tpu_torch.utils.checkpoint import find_run_config
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    summary = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=64", "algo.run_test=false"])
    cfg = load_config(find_run_config(summary["checkpoint"]))
    policy = resolve_policy_builder("ppo_anakin")(cfg, load_checkpoint(summary["checkpoint"]), torch.device("cpu"))
    obs = {"state": torch.zeros(3, 4)}
    actions = policy.greedy_fn(policy.params, obs)
    assert actions.shape == (3, 1) and set(actions.reshape(-1).tolist()) <= {0, 1}


def test_torch_anakin_loop_dry_run(tmp_path):
    summary = cli.run(SMALL + [f"log_root={tmp_path}", "dry_run=true", "algo.run_test=false"])
    assert summary["iterations"] == 1 and summary["blocks"] == 1


@pytest.mark.parametrize("env_id", ["Pendulum-v1", "Acrobot-v1", "MountainCar-v0"])
def test_torch_anakin_loop_runs_every_device_env(tmp_path, env_id):
    summary = cli.run(SMALL + [f"log_root={tmp_path}", f"env.id={env_id}", "algo.total_steps=128",
                               "algo.run_test=false"])
    assert summary["iterations"] == 2 and np.isfinite(np.asarray(summary["losses"])).all()


def test_torch_anakin_loop_refuses_an_env_without_a_device_twin(tmp_path):
    with pytest.raises(ValueError, match="requires a device environment"):
        cli.run(SMALL + [f"log_root={tmp_path}", "env.id=discrete_dummy"])


def test_torch_anakin_loop_population_trigger_and_warning(tmp_path, monkeypatch):
    population = importlib.import_module("sheeprl_tpu_torch.algos.ppo.ppo_anakin_population")
    monkeypatch.setattr(population, "population_main", lambda cfg, device: {"routed": int(cfg.algo.population.size)})
    assert cli.run(SMALL + [f"log_root={tmp_path}", "algo.population.size=2"]) == {"routed": 2}
    with pytest.warns(UserWarning, match="sweep is IGNORED"):
        cli.run(SMALL + [f"log_root={tmp_path}", "dry_run=true", "algo.run_test=false",
                         "algo.population.hparams={lr: [0.001]}"])


def test_torch_anakin_loop_registry_lists_both_trainers(capsys):
    from sheeprl_tpu_torch.utils.registry import TRAINERS

    assert len(TRAINERS) == 22  # the Anakin pair and, since, the five async topologies: every JAX trainer
    rows = {r["name"]: r for r in cli.agents()}
    for name in ("ppo_anakin", "ppo_anakin_population"):
        assert rows[name]["trainer"] == TRAINERS[name] and rows[name]["evaluation"] and rows[name]["serving"]
        assert rows[name]["decoupled"] is False
    for name in ("ppo_decoupled", "ppo_sebulba", "sac_decoupled", "sac_sebulba", "dreamer_sebulba"):
        assert rows[name]["trainer"] == TRAINERS[name] and rows[name]["decoupled"] is True
    assert "ppo_anakin_population: trainer=" in capsys.readouterr().out


def test_torch_anakin_loop_iters_per_block_follows_the_jax_rule():
    cfg = preset("ppo_anakin")
    # 5,000-step logs and 16,384-step saves at 512 steps an iteration: 9-iteration blocks
    assert anakin.resolve_iters_per_block(cfg, 128, 512, True) == 9
    cfg.metric["log_level"] = 0
    assert anakin.resolve_iters_per_block(cfg, 128, 512, True) == 32
    cfg.algo["iters_per_block"] = 200
    assert anakin.resolve_iters_per_block(cfg, 128, 512, True) == 128
    # the episode arrays' bound divides by the population: (P, iters, T, N) elements
    cfg.algo["iters_per_block"] = 10**6
    assert anakin.resolve_iters_per_block(cfg, 1 << 20, 512, True) == anakin.FERRY_ELEMS_BOUND // 512
    assert anakin.resolve_iters_per_block(cfg, 1 << 20, 512, True, population_size=8) == anakin.FERRY_ELEMS_BOUND // 4096
