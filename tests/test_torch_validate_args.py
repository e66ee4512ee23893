"""``buffer.validate_args``, ``distribution.validate_args`` and the ``ops``
block of the port, held to the JAX package's errors on the same inputs, on
the CPU.

- The host buffers' ``add(..., validate_args=True)`` raises the JAX
  buffers' error types with their messages (``ReplayBuffer``,
  ``SequentialReplayBuffer``, ``EnvIndependentReplayBuffer``,
  ``EpisodeBuffer``), and every loop of the port passes
  ``cfg.buffer.validate_args`` at its ``rb.add`` sites.
- ``set_validate_args(True)`` turns on the distributions' static checks at
  JAX's constructors with JAX's messages; off, neither package raises.
- An unknown ``ops.backend`` or an override of an unknown kernel raises the
  JAX registry's error types and texts; ``auto`` and ``pallas`` pass;
  ``lax`` raises the port's typed error, before any training.

Messages are compared as strings, exactly.
"""

import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sheeprl_tpu.data import buffers as jax_buffers
from sheeprl_tpu.distributions import core as jax_dist
from sheeprl_tpu.ops.kernels import registry as jax_registry
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.data import buffers as port_buffers
from sheeprl_tpu_torch.distributions import core as port_dist
from sheeprl_tpu_torch.ops import backend as port_ops


def _raised(fn):
    """``(type name, message)`` of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


def _rows(shape=(1, 2), **extra):
    data = {"obs": np.zeros(shape + (3,), np.float32), "terminated": np.zeros(shape + (1,), np.float32),
            "truncated": np.zeros(shape + (1,), np.float32)}
    data.update(extra)
    return data


# -- buffer.validate_args ------------------------------------------------------------

BAD_ROWS = {
    "not_a_dict": [np.zeros((1, 2, 3), np.float32)],
    "not_an_array": _rows(obs=[[0.0, 1.0]]),
    "one_dim": _rows(obs=np.zeros((3,), np.float32)),
    "incongruent": _rows(obs=np.zeros((2, 2, 3), np.float32)),
}


@pytest.mark.parametrize("case", list(BAD_ROWS))
@pytest.mark.parametrize("kind", ["ReplayBuffer", "SequentialReplayBuffer"])
def test_torch_validate_args_replay_buffer_raises_as_jax(kind, case):
    data = BAD_ROWS[case]
    jax_rb = getattr(jax_buffers, kind)(8, 2)
    port_rb = getattr(port_buffers, kind)(8, 2)
    want = _raised(lambda: jax_rb.add(data, validate_args=True))
    assert want is not None
    assert _raised(lambda: port_rb.add(data, validate_args=True)) == want


def test_torch_validate_args_env_independent_buffer_raises_as_jax():
    data = _rows(obs=np.zeros((2, 2, 3), np.float32))
    want = _raised(lambda: jax_buffers.EnvIndependentReplayBuffer(8, 2).add(data, validate_args=True))
    assert want is not None and want[0] == "RuntimeError"
    assert _raised(lambda: port_buffers.EnvIndependentReplayBuffer(8, 2).add(data, validate_args=True)) == want


EPISODE_CASES = {
    "not_a_dict": ([np.zeros((1, 2, 3), np.float32)], None),
    "one_dim": (_rows(obs=np.zeros((3,), np.float32)), None),
    "incongruent": (_rows(obs=np.zeros((2, 2, 3), np.float32)), None),
    "no_truncated": ({"obs": np.zeros((1, 2, 3), np.float32), "terminated": np.zeros((1, 2, 1), np.float32)}, None),
    "env_out_of_range": (_rows(), [0, 2]),
}


@pytest.mark.parametrize("case", list(EPISODE_CASES))
def test_torch_validate_args_episode_buffer_raises_as_jax(case):
    data, envs = EPISODE_CASES[case]
    want = _raised(lambda: jax_buffers.EpisodeBuffer(64, 2, n_envs=2).add(data, envs, validate_args=True))
    assert want is not None
    assert _raised(lambda: port_buffers.EpisodeBuffer(64, 2, n_envs=2).add(data, envs, validate_args=True)) == want


def test_torch_validate_args_buffers_accept_good_rows_either_way():
    for flag in (False, True):
        rb = port_buffers.ReplayBuffer(8, 2)
        rb.add(_rows(), validate_args=flag)
        assert not rb.empty
        ep = port_buffers.EpisodeBuffer(64, 2, n_envs=2)
        ep.add(_rows(), validate_args=flag)


def test_torch_validate_args_every_loop_passes_the_key():
    """Every host-buffer ``rb.add`` of the port's loops passes
    ``cfg.buffer.validate_args``, as JAX's 32 sites in 17 loops do (the
    port's 15 sites serve the same loops: one Dreamer V2 loop runs V2, V1
    and the four P2E V1/V2 mains)."""
    root = pathlib.Path(port_buffers.__file__).resolve().parents[1] / "algos"
    sites = {}
    for path in sorted(root.rglob("*.py")):
        for line in path.read_text().splitlines():
            if re.search(r"\brb\.add\(", line):
                sites.setdefault(path.name, []).append("validate_args=cfg.buffer" in line)
    assert sum(len(v) for v in sites.values()) == 15
    assert all(all(v) for v in sites.values()), sites


@pytest.mark.parametrize("flag", [True, False])
def test_torch_validate_args_a_run_checks_its_rows(monkeypatch, tmp_path, flag):
    """``buffer.validate_args=True`` reaches the buffer of a running loop."""
    calls = []
    real = port_buffers.ReplayBuffer._validate_add
    monkeypatch.setattr(port_buffers.ReplayBuffer, "_validate_add",
                        lambda self, data: calls.append(1) or real(self, data))
    cli.run(["preset=sac", "fabric.accelerator=cpu", "dry_run=True", "metric.log_level=0", "algo.run_test=False",
             f"buffer.validate_args={flag}", f"log_root={tmp_path}"])
    assert bool(calls) == flag


# -- distribution.validate_args ------------------------------------------------------

DIST_CASES = {
    "normal_not_broadcastable": ("Normal", ((3,), (4,)), (np.float32, np.float32)),
    "normal_integer_loc": ("Normal", ((3,), (3,)), (np.int32, np.float32)),
    "normal_integer_scale": ("Normal", ((2,), (2,)), (np.float32, np.int32)),
    "one_hot_scalar_logits": ("OneHotCategorical", ((),), (np.float32,)),
    "truncated_not_broadcastable": ("TruncatedNormal", ((2,), (3,)), (np.float32, np.float32)),
}


def _build(module, name, arrays, to):
    return getattr(module, name)(*[to(a) for a in arrays])


@pytest.fixture
def validating():
    jax_dist.set_validate_args(True)
    port_dist.set_validate_args(True)
    yield
    jax_dist.set_validate_args(False)
    port_dist.set_validate_args(False)


@pytest.mark.parametrize("case", list(DIST_CASES))
def test_torch_validate_args_distributions_raise_as_jax(validating, case):
    name, shapes, dtypes = DIST_CASES[case]
    arrays = [np.ones(s, d) for s, d in zip(shapes, dtypes)]
    want = _raised(lambda: _build(jax_dist, name, arrays, jnp.asarray))
    assert want is not None and want[0] == "ValueError"
    assert _raised(lambda: _build(port_dist, name, arrays, torch.from_numpy)) == want


@pytest.mark.parametrize("case", ["normal_not_broadcastable", "normal_integer_loc"])
def test_torch_validate_args_distributions_off_raise_nothing(case):
    """Off (the default), neither package checks the arguments at
    construction."""
    name, shapes, dtypes = DIST_CASES[case]
    arrays = [np.ones(s, d) for s, d in zip(shapes, dtypes)]
    assert not port_dist.validate_args()
    assert _raised(lambda: _build(jax_dist, name, arrays, jnp.asarray)) is None
    assert _raised(lambda: _build(port_dist, name, arrays, torch.from_numpy)) is None


def test_torch_validate_args_distributions_accept_good_arguments(validating):
    port_dist.Normal(torch.zeros(2, 3), torch.ones(3))
    port_dist.Normal(torch.zeros(3), 1.0)  # Dreamer V2's unit scale
    port_dist.OneHotCategorical(torch.zeros(4, 5))
    port_dist.TruncatedNormal(torch.zeros(2, 3), torch.ones(2, 3))


def test_torch_validate_args_run_wires_the_distribution_key(monkeypatch, tmp_path):
    seen = []
    sac = importlib.import_module("sheeprl_tpu_torch.algos.sac.sac")
    monkeypatch.setattr(sac, "main", lambda cfg, device: seen.append(port_dist.validate_args()) or {})
    try:
        for flag in (True, False):
            cli.run(["preset=sac", "fabric.accelerator=cpu", f"distribution.validate_args={flag}",
                     f"log_root={tmp_path}"])
    finally:
        port_dist.set_validate_args(False)
    assert seen == [True, False]


# -- ops.backend and ops.kernels ------------------------------------------------------

OPS_CASES = {
    "unknown_backend": {"backend": "cuda"},
    "unknown_kernel": {"backend": "auto", "kernels": {"fused_adam": "auto"}},
    "unknown_override_backend": {"kernels": {"gae": "triton"}},
}


@pytest.fixture
def jax_ops_reset():
    yield
    jax_registry.configure(reset=True)


@pytest.mark.parametrize("case", list(OPS_CASES))
def test_torch_validate_args_ops_errors_are_jax_s(jax_ops_reset, case):
    block = OPS_CASES[case]
    want = _raised(lambda: jax_registry.configure_from_config(block))
    assert want is not None and want[0] in ("UnknownOpsBackendError", "UnknownKernelError")
    assert _raised(lambda: port_ops.configure_from_config(block)) == want


def test_torch_validate_args_ops_kernel_names_are_jax_s():
    assert port_ops.KERNEL_NAMES == jax_registry.names()


@pytest.mark.parametrize("block", [None, {}, {"backend": "auto", "kernels": {}}, {"backend": "pallas"},
                                   {"kernels": {"sumtree_sample": "pallas", "gae": "auto"}}])
def test_torch_validate_args_ops_auto_and_pallas_keep_the_dispatch_rule(block):
    port_ops.configure_from_config(block)


@pytest.mark.parametrize("block", [{"backend": "lax"}, {"kernels": {"gru_gates": "lax"}}])
def test_torch_validate_args_ops_lax_is_refused(block):
    with pytest.raises(port_ops.OpsBackendNotPortedError, match="the port has no backend switch"):
        port_ops.configure_from_config(block)


def test_torch_validate_args_ops_lax_stops_a_run_before_training(monkeypatch, tmp_path):
    sac = importlib.import_module("sheeprl_tpu_torch.algos.sac.sac")
    monkeypatch.setattr(sac, "main", lambda cfg, device: pytest.fail("trained under ops.backend=lax"))
    with pytest.raises(port_ops.OpsBackendNotPortedError, match=r"^ops\.backend=lax"):
        cli.run(["preset=sac", "fabric.accelerator=cpu", "ops.backend=lax", f"log_root={tmp_path}"])
    with pytest.raises(port_ops.UnknownKernelError):
        cli.run(["preset=sac", "fabric.accelerator=cpu", "ops.kernels.gaee=auto", f"log_root={tmp_path}"])
