"""The port's gru_gates against the JAX package's.

On the CPU the port's wrapper runs its plain version, which must match the
JAX Pallas kernel (interpret mode) and the JAX reference; its autograd
backward must match the JAX custom_vjp. The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda_kernels.py``); here the tests show that a non-CPU tensor never
reaches the plain version and that a missing compiler is a named error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.kernels import gru as jax_gru
from sheeprl_tpu.ops.kernels import registry as jax_registry
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.ops.kernels import _build
from sheeprl_tpu_torch.ops.kernels import gru as torch_gru

SHAPES = [(1, 8), (5, 16), (32, 64), (300, 12)]
IDS = ["B1", "odd-batch", "serve-bucket", "multi-block"]


def _inputs(B, H, seed=0):
    rng = np.random.default_rng(seed)
    fused = rng.normal(size=(B, 3 * H)).astype(np.float32) * 2.0
    h = rng.normal(size=(B, H)).astype(np.float32)
    return fused, h


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_torch_gru_gates_matches_jax_pallas_and_reference(shape):
    """f32: atol 1e-6 (the same elementwise chain in float32 on both sides)."""
    fused, h = _inputs(*shape)
    got = K.gru_gates(torch.from_numpy(fused), torch.from_numpy(h)).numpy()
    with jax_registry.use_backend("pallas"):
        pallas = np.asarray(jax_gru.gru_gates(jnp.asarray(fused), jnp.asarray(h)))
    reference = np.asarray(jax_gru.gru_gates_reference(jnp.asarray(fused), jnp.asarray(h)))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, reference, rtol=1e-6, atol=1e-6)


def test_torch_gru_gates_bf16_inputs():
    """bf16 inputs: the Pallas kernel computes in f32 and rounds its output to
    bf16; the port's reference on the same bf16 values, taken in f32, must
    agree within one bf16 rounding (atol 1e-2, rtol 1e-2)."""
    fused, h = _inputs(16, 32, seed=4)
    f_bf = jnp.asarray(fused, dtype=jnp.bfloat16)
    h_bf = jnp.asarray(h, dtype=jnp.bfloat16)
    pallas = jax_gru.gru_gates_pallas(f_bf, h_bf)
    assert pallas.dtype == jnp.bfloat16
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    got = K.gru_gates_reference(f32(f_bf), f32(h_bf)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, dtype=np.float32), rtol=1e-2, atol=1e-2)
    # the bf16 plain version keeps the IO dtype
    assert K.gru_gates(f32(f_bf).bfloat16(), f32(h_bf).bfloat16()).dtype == torch.bfloat16


def test_torch_gru_gates_backward_matches_jax_custom_vjp(monkeypatch):
    """The autograd.Function's backward (the reference chain re-derived)
    against jax.grad through the Pallas custom_vjp, f32 atol 1e-6. The
    launch is stood in by the plain version, since no CUDA kernel runs
    here; what is under test is the backward."""
    monkeypatch.setattr(torch_gru, "_launch", lambda f, h: torch_gru.gru_gates_reference(f, h))
    fused, h = _inputs(6, 8, seed=1)
    f_t = torch.from_numpy(fused).requires_grad_(True)
    h_t = torch.from_numpy(h).requires_grad_(True)
    (torch_gru._GruGates.apply(f_t, h_t) ** 2).sum().backward()
    loss = lambda f, hh: jnp.sum(jax_gru.gru_gates_pallas(f, hh) ** 2)  # noqa: E731
    g_f, g_h = jax.grad(loss, argnums=(0, 1))(jnp.asarray(fused), jnp.asarray(h))
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(g_f), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(g_h), rtol=1e-5, atol=1e-6)


def test_torch_gru_gates_cpu_path_launches_nothing():
    before = K.LAUNCHES["gru_gates"]
    fused, h = _inputs(4, 8)
    K.gru_gates(torch.from_numpy(fused), torch.from_numpy(h))
    assert K.LAUNCHES["gru_gates"] == before


def test_torch_gru_gates_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which checks its device
    and raises: there is no fallback to the plain version."""
    fused = torch.empty((2, 12), device="meta")
    h = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        K.gru_gates(fused, h)
    with pytest.raises(ValueError, match="CUDA device"):
        K.gru_gates(torch.zeros(2, 12), h)


def test_torch_gru_gates_missing_nvcc_is_a_named_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load("gru_gates")
    with pytest.raises(_build.KernelBuildError, match="no kernel source"):
        _build.load("no_such_kernel")
