"""The port's ``evaluation`` and ``agents`` verbs on the CPU
(``fabric.accelerator=cpu``), and its PPO and SAC greedy test episodes
against the JAX package's ``test`` (``sheeprl_tpu/algos/ppo/utils.py``,
``sac/utils.py``) on the same weights, carried across by
``ppo_state_from_jax`` / ``sac_state_from_jax``, and the same env seed.

CartPole returns are equal: the port's CartPole is gymnasium's bit for bit
and the greedy actions are argmax indices. Pendulum returns agree within
relative 1e-6: the greedy torques differ by a few float32 ulps per step
(products summed in another order), which the 200 steps of dynamics carry
into the return (2.3e-8 at most over seeds 0-5).
"""

import re

import gymnasium as gym
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_ppo
from sheeprl_tpu.algos.ppo.utils import test as jax_ppo_test
from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_sac
from sheeprl_tpu.algos.sac.utils import test as jax_sac_test
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.ppo.agent import build_agent as build_ppo
from sheeprl_tpu_torch.algos.ppo.utils import test as ppo_test
from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac
from sheeprl_tpu_torch.algos.sac.utils import test as sac_test
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax, sac_state_from_jax

from tests.test_torch_sac_loop import TINY as SAC_TINY
from tests.test_torch_serve_stateless import JAX_COMMON, _perturbed
from tests.test_torch_train_loop import TINY_RUN


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_reward(capsys) -> float:
    out = capsys.readouterr().out
    return float(re.findall(r"Test - Reward: (\S+)", out)[-1])


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_torch_eval_verbs_cartpole_test_episode_matches_jax(seed, tmp_path, capsys):
    fabric = Fabric(devices=1, accelerator="cpu")
    cfg = compose(["exp=ppo", "env.id=CartPole-v1", f"seed={seed}"] + JAX_COMMON)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    _, params, _ = jax_build_ppo(fabric, (2,), False, cfg, obs_space, None)
    params = _perturbed(params, seed)
    _, params, jax_player = jax_build_ppo(fabric, (2,), False, cfg, obs_space, params)
    jax_ppo_test(jax_player, params, fabric, cfg, str(tmp_path))
    want = _jax_reward(capsys)

    port_cfg = apply_overrides(preset("ppo"), [f"seed={seed}"])
    _, player = build_ppo(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_state_from_jax(params))
    reward, steps = ppo_test(player, port_cfg, "cpu")
    assert reward == want and steps == int(want)  # +1 per step


@pytest.mark.parametrize("seed", [0, 7])
def test_torch_eval_verbs_pendulum_test_episode_matches_jax(seed, tmp_path, capsys):
    fabric = Fabric(devices=1, accelerator="cpu")
    cfg = compose(["exp=sac", "env.id=Pendulum-v1", f"seed={seed}"] + JAX_COMMON)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
    _, params, _ = jax_build_sac(fabric, cfg, obs_space, act_space, None)
    params = _perturbed(params, seed)
    _, params, jax_player = jax_build_sac(fabric, cfg, obs_space, act_space, params)
    jax_sac_test(jax_player, params, fabric, cfg, str(tmp_path))
    want = _jax_reward(capsys)

    port_cfg = apply_overrides(preset("sac"), [f"seed={seed}"])
    space = {"shape": [1], "low": [-2.0], "high": [2.0]}
    _, player = build_sac(port_cfg, 3, space, "cpu", sac_state_from_jax(params))
    reward, steps = sac_test(player, port_cfg, "cpu")
    assert steps == 200
    assert reward == pytest.approx(want, rel=1e-6)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A port checkpoint of each family, trained briefly on the CPU with the
    end-of-run test episode on."""
    root = tmp_path_factory.mktemp("runs")
    torch.set_num_threads(1)
    runs = {
        "ppo": cli.run(["preset=ppo", "fabric.accelerator=cpu", "metric.log_level=0", "algo.total_steps=1024",
                        f"log_root={root}"]),
        "sac": cli.run(["preset=sac", f"log_root={root}", "algo.total_steps=96"]
                       + [o for o in SAC_TINY if o != "algo.run_test=false"]),
        "dreamer_v3": cli.run(TINY_RUN + [f"log_root={root}", "algo.total_steps=12"]),
    }
    return runs


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_torch_eval_verbs_evaluation_replays_the_runs_greedy_test(checkpoints, algo):
    """PPO and SAC end their runs in a greedy test episode: ``evaluation`` of
    the last checkpoint, on the same seed, gives the same return and length."""
    run = checkpoints[algo]
    assert run["test_reward"] is not None and run["test_steps"] > 0
    result = cli.evaluation([f"checkpoint_path={run['checkpoint']}", "fabric.accelerator=cpu"])
    assert result == {"reward": run["test_reward"], "steps": run["test_steps"], "device": "cpu"}


def test_torch_eval_verbs_evaluation_of_a_rssm_checkpoint(checkpoints):
    """DreamerV3's run ends in a sampled test episode; ``evaluation`` runs a
    greedy one, deterministic for a seed (its draws are counters), on the
    checkpoint's seed unless ``seed=`` says otherwise."""
    run = checkpoints["dreamer_v3"]
    assert np.isfinite(run["test_reward"]) and run["test_steps"] > 300  # the dummy's 3 lives
    args = [f"checkpoint_path={run['checkpoint']}", "fabric.accelerator=cpu"]
    first, again = cli.evaluation(args), cli.evaluation(args)
    assert first == again and first["device"] == "cpu" and np.isfinite(first["reward"]) and first["steps"] > 300
    other = cli.evaluation(args + ["seed=6"])
    assert other["steps"] != first["steps"] or other["reward"] != first["reward"]


def test_torch_eval_verbs_evaluation_takes_the_config_beside_the_checkpoint(checkpoints):
    run = checkpoints["ppo"]
    cfg = cli.compose_eval_config([f"checkpoint_path={run['checkpoint']}", "fabric.accelerator=cpu"])
    assert cfg.env.num_envs == 1 and cfg.seed == 42 and cfg.algo.name == "ppo" and cfg.fabric.accelerator == "cpu"
    assert cli.compose_eval_config([f"checkpoint_path={run['checkpoint']}", "seed=3"]).seed == 3
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.evaluation(["fabric.accelerator=cpu"])


def test_torch_eval_verbs_evaluation_needs_a_card_unless_asked_for_the_cpu(checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in checkpoints.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.evaluation([f"checkpoint_path={run['checkpoint']}"])


def test_torch_eval_verbs_main_dispatches_eval_and_agents(checkpoints, capsys):
    run = checkpoints["ppo"]
    cli.main(["eval", f"checkpoint_path={run['checkpoint']}", "fabric.accelerator=cpu"])
    assert f"Test - Reward: {run['test_reward']}" in capsys.readouterr().out
    cli.main(["agents"])
    out = capsys.readouterr().out
    for name in ("dreamer_v3", "ppo", "sac"):
        assert re.search(rf"^{name}: trainer=sheeprl_tpu_torch\.algos\.{name}\.{name}, evaluation=True, serving=True, "
                         rf"decoupled=False$", out, re.M), out


def test_torch_eval_verbs_agents_lists_the_three_families():
    rows = {row["name"]: row for row in cli.agents()}
    for name in ("dreamer_v3", "ppo", "sac"):
        assert rows[name] == {"name": name, "trainer": f"sheeprl_tpu_torch.algos.{name}.{name}",
                              "evaluation": True, "serving": True, "decoupled": False}
    assert rows["dreamer_sebulba"]["trainer"] == "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba"
    assert rows["dreamer_sebulba"]["decoupled"] and rows["dreamer_sebulba"]["serving"]
    with pytest.raises(ValueError, match="no arguments"):
        cli.agents(["x=1"])
