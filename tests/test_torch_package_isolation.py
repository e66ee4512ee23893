"""The port stands alone: it imports no JAX, flax, optax, orbax or
``sheeprl_tpu`` module, and neither YAML nor gymnasium, which the machine
with the GPU does not have. Checked twice: every submodule imports in a
subprocess where those modules are blocked, and an AST scan of the package
(and of ``chip_smoke.py``) finds no such import."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import sheeprl_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sheeprl_tpu", "yaml", "gymnasium", "gym")

_BLOCKED_IMPORT = f"""
import importlib, json, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import sheeprl_tpu_torch
names = ["sheeprl_tpu_torch"] + [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r} and sys.modules[m] is not None)
print(json.dumps({{"imported": names, "leaked": leaked}}))
"""


def _submodules():
    return ["sheeprl_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")
    ]


def test_torch_package_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert set(report["imported"]) == set(_submodules())
    assert "sheeprl_tpu_torch.ops.kernels.gru" in report["imported"]
    assert "sheeprl_tpu_torch.ops.kernels.twohot" in report["imported"]
    assert "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3" in report["imported"]
    assert "sheeprl_tpu_torch.ops.kernels.gae" in report["imported"]
    assert "sheeprl_tpu_torch.algos.ppo.ppo" in report["imported"]
    for name in ("ops.kernels.sumtree", "replay.sumtree", "replay.device_buffer", "data.ring", "algos.sac.sac",
                 "algos.sac.agent", "algos.sac.loss", "algos.sac.utils", "ops.kernels.scatter", "replay.driver",
                 "utils.burst", "utils.convert", "serve.engine", "serve.policy", "algos.ppo.evaluate",
                 "algos.sac.evaluate", "algos.dreamer_v3.evaluate", "utils.registry", "cli", "fault", "fault.inject",
                 "fault.manager", "fault.sentinel", "fault.watchdog", "ops.guard", "utils.checkpoint",
                 "utils.logger", "utils.metric", "utils.timer", "data.memmap", "fault.supervisor", "serve.weights",
                 "algos.a2c.a2c", "algos.a2c.agent", "algos.a2c.evaluate", "algos.a2c.utils",
                 "algos.ppo_recurrent.ppo_recurrent", "algos.ppo_recurrent.agent", "algos.ppo_recurrent.evaluate",
                 "algos.ppo_recurrent.utils", "envs.dummy", "optim.builders", "distributions.core",
                 "algos.droq.agent", "algos.droq.droq", "algos.droq.evaluate", "algos.droq.utils",
                 "algos.sac_ae.agent", "algos.sac_ae.sac_ae", "algos.sac_ae.evaluate", "algos.sac_ae.utils",
                 "data.buffers", "models.blocks", "envs.wrappers", "envs.classic", "algos.p2e_dv3.agent",
                 "algos.p2e_dv3.p2e_dv3_exploration", "algos.p2e_dv3.p2e_dv3_finetuning", "algos.p2e_dv3.evaluate",
                 "algos.p2e_dv3.utils", "algos.dreamer_v2.agent", "algos.dreamer_v2.dreamer_v2",
                 "algos.dreamer_v2.evaluate", "algos.dreamer_v2.loss", "algos.dreamer_v2.utils", "algos.p2e_dv2.agent",
                 "algos.p2e_dv2.p2e_dv2_exploration", "algos.p2e_dv2.p2e_dv2_finetuning", "algos.p2e_dv2.evaluate",
                 "algos.p2e_dv2.utils", "algos.dreamer_v1.agent", "algos.dreamer_v1.dreamer_v1",
                 "algos.dreamer_v1.evaluate", "algos.dreamer_v1.loss", "algos.dreamer_v1.utils", "algos.p2e_dv1.agent",
                 "algos.p2e_dv1.p2e_dv1_exploration", "algos.p2e_dv1.p2e_dv1_finetuning", "algos.p2e_dv1.evaluate",
                 "algos.p2e_dv1.utils", "algos.ppo.ppo_anakin", "algos.ppo.ppo_anakin_population",
                 "envs.device_envs", "envs.device_envs.base", "envs.device_envs.cartpole", "envs.device_envs.pendulum",
                 "envs.device_envs.acrobot", "envs.device_envs.mountain_car", "fault.procsup", "serve.fleet",
                 "serve.flywheel", "algos.sac.flywheel", "serve.server", "serve.scheduler"):
        assert f"sheeprl_tpu_torch.{name}" in report["imported"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    # tests/conftest.py marks node ids that name "dreamer", "p2e", "droq" or
    # "sac_ae" as slow, which would leave those modules out of the default run
    ids=lambda p: (p.relative_to(ROOT).as_posix().replace("dreamer_v3", "dv3").replace("dreamer_v2", "dv2")
                   .replace("p2e_", "explore_")
                   .replace("droq", "q_dropout").replace("sac_ae", "pixel_ae")),
)
def test_torch_package_source_imports_nothing_forbidden(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_torch_package_ships_its_kernel_sources():
    sources = sorted(p.name for p in (PACKAGE / "csrc").glob("*.cu"))
    assert sources == ["gae.cu", "gru_gates.cu", "ring_scatter.cu", "sumtree.cu", "two_hot.cu"]


@pytest.mark.parametrize(
    "source, launchers, replaces",
    [
        ("gru_gates.cu", ["gru_gates_launch"], ["sheeprl_tpu/ops/kernels/gru.py", "_pallas_forward"]),
        ("gae.cu", ["gae_launch"], ["sheeprl_tpu/ops/kernels/gae.py:56", "_gae_pallas_forward"]),
        ("sumtree.cu", ["sumtree_sample_launch"], ["sheeprl_tpu/ops/kernels/sumtree.py:68", "_sumtree_pallas_forward"]),
        (
            "ring_scatter.cu",
            ["ragged_ring_scatter_launch"],
            ["sheeprl_tpu/ops/kernels/scatter.py:68", "_scatter_pallas_forward"],
        ),
        (
            "two_hot.cu",
            ["two_hot_symlog_loss_launch", "two_hot_symexp_decode_launch"],
            ["sheeprl_tpu/ops/kernels/twohot.py:133", "_loss_pallas_forward", "twohot.py:158", "_decode_pallas_forward"],
        ),
    ],
)
def test_torch_package_kernel_source_names_what_it_replaces(source, launchers, replaces):
    text = (PACKAGE / "csrc" / source).read_text()
    for name in launchers:
        assert f'extern "C" int {name}' in text
    for ref in replaces:
        assert ref in text  # the TPU kernel it replaces
