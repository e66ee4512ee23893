"""``fabric.precision`` through the port's verbs, against the JAX package's
CLI, on the CPU.

The repair: the port took any ``fabric.precision`` and trained in float32.
Now ``run`` (``compose_run_config``, beside ``check_configs``),
``evaluation`` and ``serve`` raise the JAX package's ``ValueError`` on an
unknown one, and a known one reaches every family's ``build_agent``: each
layer that holds a compute dtype holds the alias's, and the agent's output
is in it. The presets carry their JAX recipes' precisions. A ``bf16-mixed``
run's checkpoint holds float32 parameters, optimizer state and buffers, and
``evaluation`` and ``serve`` of it compute in the run's precision.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel.fabric import Precision as JaxPrecision
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from tests.test_torch_rssm_continuous_loop import TINY as CONTINUOUS_TINY
from tests.test_torch_rssm_v1_loop import TINY as V1_TINY
from tests.test_torch_rssm_v2_loop import TINY as V2_TINY
from tests.test_torch_train_loop import TINY_RUN

BF16 = torch.bfloat16
PIXELS = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}}, "actions": {"n": [18], "continuous": False}}
BOX = {"shape": [2], "low": [-1.0, -1.0], "high": [1.0, 1.0], "continuous": True}


def _jax_error(spec):
    with pytest.raises(ValueError) as err:
        JaxPrecision.from_string(spec)
    return str(err.value)


def test_torch_precision_cli_run_rejects_an_unknown_precision():
    with pytest.raises(ValueError) as err:
        cli.compose_run_config(["preset=ppo", "fabric.precision=nonsense", "fabric.accelerator=cpu"])
    assert str(err.value) == _jax_error("nonsense")
    with pytest.raises(ValueError, match="Unknown precision 'bf16'"):
        cli.run(["preset=ppo", "fabric.precision=bf16", "fabric.accelerator=cpu"])


@pytest.mark.parametrize("spec", ["32-true", "32", "bf16-mixed", "bf16-true", "16-mixed", "16-true"])
def test_torch_precision_cli_run_keeps_a_known_precision(spec):
    cfg = cli.compose_run_config(["preset=ppo", f"fabric.precision={spec}", "fabric.accelerator=cpu"])
    assert str(cfg.fabric.precision) == spec  # "32" parses as a number, which the policy reads as its text


def test_torch_precision_cli_run_defaults_to_the_jax_default():
    cfg = cli.compose_run_config(["preset=ppo", "fabric.accelerator=cpu"])
    assert cfg.fabric.precision == compose(["exp=ppo"]).fabric.precision == "32-true"


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """A tiny continuous DreamerV3 run at its recipe's bf16-mixed."""
    root = tmp_path_factory.mktemp("bf16")
    torch.manual_seed(0)
    summary = cli.run(CONTINUOUS_TINY + ["algo.total_steps=24", f"log_root={root}", "run_name=bf16"])
    return summary, root


def _float_dtypes(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            out.add(tree.dtype)
    elif isinstance(tree, dict):
        for v in tree.values():
            _float_dtypes(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _float_dtypes(v, out)
    return out


def test_torch_precision_cli_bf16_run_keeps_float32_state(bf16_run):
    summary, _ = bf16_run
    assert np.isfinite(np.asarray(summary["metrics"])).all() and summary["gradient_steps"] > 0
    state = load_checkpoint(summary["checkpoint"])
    for key in ("world_model", "actor", "critic", "target_critic", "optimizers", "moments"):
        assert _float_dtypes(state[key], set()) == {torch.float32}, key
    config = json.loads(find_run_config(summary["checkpoint"]).read_text())
    assert config["fabric"]["precision"] == "bf16-mixed"


def _with_precision(summary, root, spec, tmp_path):
    """A copy of the run's checkpoint whose run config names ``spec``."""
    ckpt = tmp_path / "ckpt.ckpt"
    shutil.copy(summary["checkpoint"], ckpt)
    config = json.loads(find_run_config(summary["checkpoint"]).read_text())
    config["fabric"]["precision"] = spec
    (tmp_path / "config.json").write_text(json.dumps(config))
    return ckpt


def test_torch_precision_cli_evaluation_and_serve_reject_an_unknown_precision(bf16_run, tmp_path):
    ckpt = _with_precision(*bf16_run, "nonsense", tmp_path)
    for verb in (cli.evaluation, cli.serve):
        with pytest.raises(ValueError) as err:
            verb([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.max_requests=0"]
                 if verb is cli.serve else [f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
        assert str(err.value) == _jax_error("nonsense")


def test_torch_precision_cli_evaluation_and_serve_take_the_run_precision(bf16_run, monkeypatch):
    """As the JAX verbs read it: the checkpoint run's own precision; a
    ``fabric.precision`` on the serve command line does not change it."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate

    summary, _ = bf16_run
    built = []
    real = evaluate.build_agent

    def spy(cfg, device, state=None):
        out = real(cfg, device, state)
        built.append((cfg.fabric.precision, out[0].encoder.cnn_encoder.conv_0.dtype))
        return out

    monkeypatch.setattr(evaluate, "build_agent", spy)
    result = cli.evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])
    assert result["steps"] == summary["test_steps"] and result["reward"] == summary["test_reward"]
    cfg = cli.compose_serve_config([f"checkpoint_path={summary['checkpoint']}", "fabric.precision=32-true"])
    assert cfg.fabric.precision == "bf16-mixed"
    assert built and all(b == ("bf16-mixed", BF16) for b in built)


def _spaced(name, extra=(), spaces=None):
    cfg = apply_overrides(preset(name), list(extra))
    if spaces is not None:
        cfg["spaces"] = spaces
    return apply_overrides(cfg, [])


def _compute_dtypes(modules):
    out = set()
    for module in modules:
        for m in module.modules():
            if isinstance(getattr(type(m), "dtype", None), torch.dtype):
                out.add(m.dtype)
    return out


def _build(family, spec):
    """The agent (as a list of modules) of ``family`` at ``spec``."""
    p = [f"fabric.precision={spec}"]
    if family == "ppo":
        from sheeprl_tpu_torch.algos.ppo.agent import build_agent
        return [build_agent(_spaced("ppo", p), (2,), False, {"state": {"shape": [4]}})[0]]
    if family == "a2c":
        from sheeprl_tpu_torch.algos.a2c.agent import build_agent
        return [build_agent(_spaced("a2c", p), (2,), False, {"state": {"shape": [4]}})[0]]
    if family == "anakin":
        from sheeprl_tpu_torch.algos.ppo.agent import build_agent
        return [build_agent(_spaced("ppo_anakin", p), (2,), False, {"state": {"shape": [4]}})[0]]
    if family == "recurrent":
        from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
        return [build_agent(_spaced("ppo_recurrent", p), (2,), False, {"state": {"shape": [4]}})[0]]
    if family in ("sac", "q_dropout"):
        from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_q
        from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac
        build = build_sac if family == "sac" else build_q
        return [build(_spaced("sac" if family == "sac" else "droq", p), 3, {"shape": [1], "low": [-2.0],
                                                                            "high": [2.0]})[0]]
    if family == "pixel_sac":
        from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
        small = ["algo.encoder.cnn_channels_multiplier=1", "algo.decoder.cnn_channels_multiplier=1"]
        return [build_agent(_spaced("sac_ae", p + small, {"obs": PIXELS["obs"], "actions": BOX}))[0]]
    import importlib
    v3 = TINY_RUN[1:] + ["algo.ensembles.n=2", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1"]
    names = {"v3": ("dreamer_v3", "dreamer_v3_100k_atari_dummy", "build_training_agent", TINY_RUN[1:]),
             "v2": ("dreamer_v2", "dreamer_v2_atari_dummy", "build_agent", V2_TINY),
             "v1": ("dreamer_v1", "dreamer_v1_atari_dummy", "build_agent", V1_TINY),
             "explore_v3": ("p2e_dv3", "p2e_dv3_exploration_atari_dummy", "build_agent", v3),
             "explore_v2": ("p2e_dv2", "p2e_dv2_exploration_atari_dummy", "build_agent", V2_TINY),
             "explore_v1": ("p2e_dv1", "p2e_dv1_exploration_atari_dummy", "build_agent", V1_TINY)}
    package, preset_name, build_name, tiny = names[family]
    agent = getattr(importlib.import_module(f"sheeprl_tpu_torch.algos.{package}.agent"), build_name)(
        _spaced(preset_name, list(tiny) + p, PIXELS))
    return list(agent) if isinstance(agent, tuple) else [agent]


FAMILIES = ["ppo", "a2c", "anakin", "recurrent", "sac", "q_dropout", "pixel_sac", "v3", "v2", "v1", "explore_v3",
            "explore_v2", "explore_v1"]


@pytest.mark.parametrize("family", FAMILIES)
def test_torch_precision_cli_reaches_every_build_agent(family):
    """Every module with a compute dtype holds bfloat16 under bf16-mixed and
    float32 under 32-true; the parameters are float32 under both (the
    Dreamer families at the tiny widths of their loop tests)."""
    for spec, want in (("bf16-mixed", BF16), ("32-true", torch.float32)):
        modules = _build(family, spec)
        assert _compute_dtypes(modules) == {want}, spec
        assert {p.dtype for m in modules for p in m.parameters()} == {torch.float32}, spec


#: each port preset composed from a JAX recipe, by a test id (the ids keep
#: clear of the words the suite's slow marker reads)
RECIPES = {
    "v3_continuous": "dreamer_v3_continuous_dummy", "explore_v3": "p2e_dv3_exploration_atari_dummy",
    "finetune_v3": "p2e_dv3_finetuning_atari_dummy", "v2": "dreamer_v2_atari_dummy",
    "v2_pacman": "dreamer_v2_ms_pacman_dummy", "explore_v2": "p2e_dv2_exploration_atari_dummy",
    "finetune_v2": "p2e_dv2_finetuning_atari_dummy", "v1": "dreamer_v1_atari_dummy",
    "explore_v1": "p2e_dv1_exploration_atari_dummy", "finetune_v1": "p2e_dv1_finetuning_atari_dummy",
    "q_dropout": "droq", "pixel_sac": "sac_ae", "sac": "sac", "anakin": "ppo_anakin",
    "population": "ppo_anakin_population",
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_torch_precision_cli_preset_has_its_recipe_precision(name):
    extra = ["checkpoint.exploration_ckpt_path=x"] if name.startswith("finetune") else []  # the recipes' ???
    port = cli.compose_run_config([f"preset={RECIPES[name]}", "fabric.accelerator=cpu"] + extra)
    recipe = preset(RECIPES[name]).preset.composition.split() + extra
    assert port.fabric.precision == str(compose(recipe).fabric.precision)
    assert not any("precision" in s for s in preset(RECIPES[name]).preset.get("substitutions", []))
