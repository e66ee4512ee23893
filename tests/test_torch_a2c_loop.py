"""The port's A2C loop through ``cli.run`` on the CPU
(``fabric.accelerator=cpu``): the preset is the JAX package's ``exp=a2c``
composition; a run trains with the plain GAE (the CUDA kernel's launch
count stays 0), takes one RMSprop step per iteration, writes its memmapped
rollout under the run directory and checkpoints; a resume continues its
counters; ``evaluation`` repeats the run's test episode; the continuous and
multi-discrete counter envs run as the JAX suite runs them
(``tests/test_algos/test_algos.py``); ``agents`` lists A2C with an
evaluation and no serving builder, as in the JAX package."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

SMALL = ["preset=a2c", "fabric.accelerator=cpu", "metric.log_level=0"]


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


@pytest.mark.parametrize("name", ["a2c", "ppo_recurrent"])
def test_torch_a2c_loop_presets_are_the_jax_exps(name):
    """Every key of the port's preset holds the value the JAX composition
    gives it (the optimizer's target names the builder by its last
    component); ``buffer.size`` is the rollout's length."""
    jax_cfg = compose([f"exp={name}"])
    port = preset(name)
    checked = 0
    for path, value in _leaves(port):
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        if path.endswith("_target_"):
            assert str(node).rsplit(".", 1)[-1] == value, path
        elif isinstance(value, float):
            assert float(node) == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 40
    assert port["buffer"]["size"] == port["algo"]["rollout_steps"]


def test_torch_a2c_loop_trains_checkpoints_and_resumes(tmp_path):
    K.reset_launches()
    first = cli.run(SMALL + [f"log_root={tmp_path}", "algo.total_steps=400", "checkpoint.every=100"])
    assert first["device"] == "cpu" and first["iterations"] == 20 and first["policy_steps"] == 400
    assert len(first["losses"]) == 20 and np.isfinite(np.asarray(first["losses"])).all()
    assert all(len(row) == 2 for row in first["losses"])
    assert K.LAUNCHES["gae"] == 0  # CPU tensors take the plain version
    files = sorted(p.name for p in (tmp_path.glob("a2c/CartPole-v1/*/version_0/memmap_buffer/rank_0/*")))
    assert files == sorted(f"{k}.memmap" for k in ("state", "actions", "values", "rewards", "dones", "returns",
                                                   "advantages"))
    state = load_checkpoint(first["checkpoint"])
    assert {"agent", "optimizer", "iter_num"} <= set(state) and state["iter_num"] == 20
    assert first["checkpoint"].endswith("ckpt_400_0.ckpt")
    nu = [s["nu"] for s in state["optimizer"]["state"].values()]
    assert nu and all(float(t.abs().sum()) > 0 for t in nu)  # RMSprop's second moment, saved

    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", f"log_root={tmp_path}", "algo.total_steps=500"])
    assert resumed["start_iter"] == 21 and resumed["iterations"] == 5 and resumed["policy_steps"] == 500
    evaluated = cli.evaluation([f"checkpoint_path={resumed['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["reward"] == resumed["test_reward"] and evaluated["steps"] == resumed["test_steps"]


@pytest.mark.parametrize("env_id", ["continuous_dummy", "multidiscrete_dummy"])
def test_torch_a2c_loop_runs_the_counter_envs(tmp_path, env_id):
    out = cli.run(SMALL + [f"env.id={env_id}", "algo.rollout_steps=8", "buffer.size=8", "algo.per_rank_batch_size=8",
                           "algo.total_steps=64", f"log_root={tmp_path}"])
    assert out["iterations"] == 2 and np.isfinite(np.asarray(out["losses"])).all()
    assert out["test_steps"] == 129  # both counter envs end on the step after their 128th


def test_torch_a2c_loop_refuses_pixels(tmp_path):
    with pytest.raises(ValueError, match="vector observations"):
        cli.run(SMALL + ["env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", f"log_root={tmp_path}",
                         "algo.total_steps=40"])


def test_torch_a2c_loop_agents_lists_the_family(capsys):
    rows = {row["name"]: row for row in cli.agents()}
    assert rows["a2c"] == {"name": "a2c", "trainer": "sheeprl_tpu_torch.algos.a2c.a2c", "evaluation": True,
                           "serving": False, "decoupled": False}
    assert rows["ppo_recurrent"] == {"name": "ppo_recurrent",
                                     "trainer": "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
                                     "evaluation": True, "serving": True, "decoupled": False}
    assert "a2c: trainer=sheeprl_tpu_torch.algos.a2c.a2c, evaluation=True, serving=False" in capsys.readouterr().out
