"""The port's population loop (``ppo_anakin_population``) through ``cli.run``
on the CPU: a population of one equals the single run bit for bit; P = 3
runs with a grid sweep, with PBT and with a scenario matrix checkpoint the
whole population and resume with the checkpoint's hyperparameters and
scenarios (not the sweep's); a resume of another size is refused; the
``ppo_anakin`` trigger stamps the population's name; evaluation and
serving take the fittest member, and a hot swap slices it out of a stacked
save."""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import load_config
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from sheeprl_tpu_torch.utils.registry import resolve_evaluation, resolve_policy_builder

TINY = ["fabric.accelerator=cpu", "metric.log_level=0", "env.num_envs=2", "algo.rollout_steps=16",
        "algo.update_epochs=1", "algo.per_rank_batch_size=16"]
POP = ["preset=ppo_anakin_population", *TINY]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_population_loop_one_member_equals_the_single_run(tmp_path):
    common = TINY + [f"log_root={tmp_path}", "algo.total_steps=256", "algo.iters_per_block=3", "algo.run_test=false"]
    single = cli.run(["preset=ppo_anakin", *common])
    one = cli.run(["preset=ppo_anakin_population", "algo.population.size=1", "algo.population.hparams={}", *common])
    a, b = load_checkpoint(single["checkpoint"]), load_checkpoint(one["checkpoint"])
    assert set(b["agent"]) == set(a["agent"])
    for k, v in a["agent"].items():
        assert b["agent"][k].shape == (1, *v.shape) and torch.equal(b["agent"][k][0], v), k
    assert single["losses"] == one["losses"] and single["episodes"] == one["episodes"]
    assert b["population_size"] == 1 and b["best_member"] == 0


def test_torch_population_loop_grid_checkpoint_resume_and_size_guard(tmp_path):
    first = cli.run(POP + [f"log_root={tmp_path}", "algo.population.size=3", "algo.population.hparams={lr: [0.001, 0.002, 0.003]}",
                           "algo.total_steps=96", "checkpoint.every=64", "algo.run_test=false"])
    assert first["iterations"] == 3 and first["population_size"] == 3
    state = load_checkpoint(first["checkpoint"])
    assert set(state) >= {"agent", "optimizer", "rng", "rollout_rng", "pop_key", "hparams", "env_params", "fitness",
                          "population_size", "best_member", "block_num", "iter_num", "train_step", "last_train"}
    assert state["population_size"] == 3 and state["block_num"] == first["blocks"]
    np.testing.assert_array_equal(np.asarray(state["hparams"]["lr"]), np.float32([0.001, 0.002, 0.003]))
    assert all(v.shape[0] == 3 for v in state["agent"].values())
    assert state["optimizer"]["exp_avg"].shape[0] == 3 and state["optimizer"]["step"].tolist() == [3 * 2] * 3
    members = state["agent"]["critic.out.weight"]
    assert not torch.equal(members[0], members[1])  # each member its own init

    # a resume keeps the checkpoint's hyperparameters, whatever the sweep now says
    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "algo.total_steps=128", f"log_root={tmp_path}", "algo.population.hparams={lr: [0.1, 0.2, 0.3]}"])
    assert resumed["start_iter"] == 4 and resumed["iterations"] == 1
    assert resumed["hparams"]["lr"] == pytest.approx([0.001, 0.002, 0.003])
    after = load_checkpoint(resumed["checkpoint"])
    assert after["optimizer"]["step"].tolist() == [4 * 2] * 3
    with pytest.raises(ValueError, match="whole population resumes together"):
        cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu", "algo.population.size=2",
                 "algo.population.hparams={}", f"log_root={tmp_path}"])


def test_torch_population_loop_pbt_rewrites_the_losers(tmp_path):
    summary = cli.run(POP + [f"log_root={tmp_path}", "algo.population.size=4", "env.id=Pendulum-v1",
                             "algo.population.hparams={lr: [0.001, 0.002, 0.003, 0.004]}",
                             "algo.population.pbt.enabled=true", "algo.iters_per_block=1", "algo.total_steps=96",
                             "algo.run_test=false"])
    assert summary["pbt_steps"] == 3 == summary["blocks"]
    lrs = summary["hparams"]["lr"]
    # the worst member took the best's rate times 0.8 or 1.25 at every step: the grid is gone
    assert sorted(lrs) != pytest.approx([0.001, 0.002, 0.003, 0.004])
    fit = np.asarray(summary["fitness"][-1])
    assert fit.shape == (4,) and np.isfinite(fit).all() and summary["best_member"] == int(fit.argmax())


def test_torch_population_loop_scenario_matrix(tmp_path):
    summary = cli.run(POP + [f"log_root={tmp_path}", "algo.population.size=2", "algo.population.hparams={}",
                             "algo.population.env_params={length: [0.25, 1.0]}", "algo.total_steps=64",
                             "algo.run_test=false"])
    state = load_checkpoint(summary["checkpoint"])
    np.testing.assert_array_equal(np.asarray(state["env_params"]["length"]), np.float32([0.25, 1.0]))
    assert np.asarray(state["env_params"]["max_episode_steps"]).dtype == np.int32
    with pytest.raises(ValueError, match=r"algo\.population\.env_params\.max_episode_steps"):
        cli.run(POP + [f"log_root={tmp_path}", "algo.population.size=2", "algo.population.hparams={}",
                       "env.max_episode_steps=50", "algo.population.env_params={max_episode_steps: [100, 200]}"])


def test_torch_population_loop_trigger_stamps_the_population_name(tmp_path):
    summary = cli.run(["preset=ppo_anakin", *TINY, f"log_root={tmp_path}", "algo.population.size=2", "dry_run=true",
                       "algo.run_test=false"])
    assert summary["population_size"] == 2 and "ppo_anakin_population/CartPole-v1" in summary["log_dir"]
    assert load_config(find_run_config(summary["checkpoint"])).algo.name == "ppo_anakin_population"


def test_torch_population_loop_dry_run(tmp_path):
    summary = cli.run(POP + [f"log_root={tmp_path}", "dry_run=true", "algo.run_test=false"])
    assert summary["iterations"] == 1 and summary["population_size"] == 8


def test_torch_population_loop_evaluation_and_serving_take_the_best_member(tmp_path):
    from sheeprl_tpu_torch.algos.ppo.evaluate import evaluate_ppo

    summary = cli.run(POP + [f"log_root={tmp_path}", "algo.population.size=3", "algo.population.hparams={}",
                             "algo.total_steps=64"])
    state = load_checkpoint(summary["checkpoint"])
    best = int(state["best_member"])
    assert best == summary["best_member"]
    cfg = load_config(find_run_config(summary["checkpoint"]))
    cfg["env"]["num_envs"] = 1
    got = resolve_evaluation("ppo_anakin_population")(cfg, state, torch.device("cpu"))
    want = evaluate_ppo(cfg, dict(state, agent={k: v[best] for k, v in state["agent"].items()}), torch.device("cpu"))
    assert got == want and got["reward"] == summary["test_reward"]
    assert cli.evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])["reward"] == got["reward"]

    policy = resolve_policy_builder("ppo_anakin_population")(cfg, state, torch.device("cpu"))
    for name, p in policy.params.state_dict().items():
        assert torch.equal(p, state["agent"][name][best])
    swapped = policy.params_from_state(state)  # a watched run publishes member-stacked saves
    for name, p in swapped.state_dict().items():
        assert p.shape == state["agent"][name].shape[1:] and torch.equal(p, state["agent"][name][best])
