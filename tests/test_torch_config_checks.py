"""The port's counterpart of the JAX CLI's ``check_configs`` and its verbless
command line, on the CPU:

- ``env.action_repeat`` below 1 composes as 1 (JAX clamps it), so the
  Atari-protocol dummy steps with a frame skip of 1; a value of 1 or more
  stays as given;
- a negative ``algo.learning_starts`` raises JAX's ``ValueError``, also
  through ``run``;
- a command line whose first word is not a verb runs ``run`` on every
  word, as ``python -m sheeprl_tpu key=value ...`` does; an empty one
  reaches ``run([])``, which asks for a preset.
"""

import pytest

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.envs import make_env


@pytest.mark.parametrize("repeat", [0, -3])
def test_torch_config_checks_clamp_action_repeat(repeat):
    cfg = cli.compose_run_config(["preset=dreamer_v3_100k_atari_dummy", f"env.action_repeat={repeat}"])
    assert cfg.env.action_repeat == 1
    env = make_env(cfg, 0)
    assert env.frame_skip == 1
    env.reset(seed=0)
    obs, reward, terminated, truncated, _ = env.step(0)
    assert obs["rgb"].shape == (64, 64, 3) and not terminated and not truncated


def test_torch_config_checks_keep_a_valid_action_repeat():
    cfg = cli.compose_run_config(["preset=dreamer_v3_100k_atari_dummy", "env.action_repeat=2"])
    assert cfg.env.action_repeat == 2 and make_env(cfg, 0).frame_skip == 2


def test_torch_config_checks_match_jax_composition():
    """The clamped value is the one JAX's composed and checked config holds."""
    from sheeprl_tpu.cli import check_configs as jax_check_configs

    jax_cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=atari_dummy", "env.action_repeat=0"])
    jax_check_configs(jax_cfg)
    cfg = cli.compose_run_config(["preset=dreamer_v3_100k_atari_dummy", "env.action_repeat=0"])
    assert cfg.env.action_repeat == jax_cfg.env.action_repeat == 1


@pytest.mark.parametrize("preset", ["ppo", "sac", "dreamer_v2_atari_dummy"], ids=["ppo", "sac", "rssm_v2"])
def test_torch_config_checks_reject_negative_learning_starts(preset):
    with pytest.raises(ValueError, match="The `algo.learning_starts` parameter must be greater or equal to zero."):
        cli.compose_run_config([f"preset={preset}", "algo.learning_starts=-5"])


def test_torch_config_checks_reject_negative_learning_starts_through_run(tmp_path):
    with pytest.raises(ValueError, match="learning_starts"):
        cli.run(["preset=ppo", "algo.learning_starts=-1", "fabric.accelerator=cpu", f"log_root={tmp_path}"])


def test_torch_config_checks_allow_zero_learning_starts():
    assert cli.compose_run_config(["preset=ppo", "algo.learning_starts=0"]).algo.learning_starts == 0


def test_torch_verbless_command_runs_run(monkeypatch):
    seen = []
    monkeypatch.setitem(cli._VERBS, "run", lambda args: seen.append(("verb", list(args))))
    monkeypatch.setattr(cli, "run", lambda args: seen.append(("default", list(args))))
    cli.main(["preset=ppo", "algo.total_steps=8"])
    cli.main(["run", "preset=ppo"])
    assert seen == [("default", ["preset=ppo", "algo.total_steps=8"]), ("verb", ["preset=ppo"])]


def test_torch_verbless_command_trains(tmp_path):
    """A verbless command line trains as ``run`` does: a PPO dry run."""
    cli.main(["preset=ppo", "dry_run=true", "fabric.accelerator=cpu", "metric.log_level=0", f"log_root={tmp_path}"])
    assert list(tmp_path.glob("ppo/*/*/version_0/checkpoint/*.ckpt"))


def test_torch_empty_command_asks_for_a_preset():
    with pytest.raises(ValueError, match="run needs preset="):
        cli.main([])
