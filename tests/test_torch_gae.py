"""The port's GAE (``sheeprl_tpu_torch/ops/kernels/gae.py``) against the JAX
package's, on the CPU.

Inputs are numpy from a seed: rewards and values ``(T, N, 1)`` or ``(T, N)``,
dones with terminal flags in the middle of columns, a bootstrap value. The
port's plain version (what its wrapper runs on CPU tensors, and what the
CUDA kernel is held against on the card) is compared with the JAX kernel
run through its Pallas body in interpret mode and through its lax
reference, within atol and rtol 1e-6: both sides accumulate in float32 in
the same op order. bf16 inputs are widened to float32 on both sides before
the recurrence. Gradients against ``jax.grad`` within 1e-5, through the
wrapper's CPU path and through the ``autograd.Function`` the card uses (its
launch swapped for the plain version, since the kernel runs only on the
card).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import kernels as JK
from sheeprl_tpu_torch.ops import kernels as K

# the module, which the package's ``gae`` function shadows as an attribute
gae_module = importlib.import_module("sheeprl_tpu_torch.ops.kernels.gae")
TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed, T, N, trailing=(1,), done_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    shape = (T, N) + trailing
    rewards = rng.normal(size=shape).astype(np.float32)
    values = (rng.normal(size=shape) * 3).astype(np.float32)
    dones = rng.uniform(size=shape) < 0.15
    if T > 2:
        dones[T // 2, 0] = True  # a terminal flag in the middle of a column
    next_value = rng.normal(size=shape[1:]).astype(np.float32)
    return rewards, values, dones.astype(done_dtype), next_value


def _jax(backend, rewards, values, dones, next_value, gamma, lam, dtype=jnp.float32):
    r, v, nv = (jnp.asarray(x, dtype=dtype) for x in (rewards, values, next_value))
    ret, adv = JK.gae(r, v, jnp.asarray(dones), nv, gamma, lam, backend=backend)
    return np.asarray(ret), np.asarray(adv)


@pytest.mark.parametrize("backend", ["pallas", "lax"])
@pytest.mark.parametrize("trailing", [(1,), ()], ids=["TN1", "TN"])
@pytest.mark.parametrize("done_dtype", [np.uint8, np.bool_, np.float32], ids=["uint8", "bool", "f32"])
@pytest.mark.parametrize("T, N", [(16, 6), (1, 7), (128, 4)], ids=["T16", "T1", "main-path"])
def test_torch_gae_matches_jax(backend, trailing, done_dtype, T, N):
    rewards, values, dones, next_value = _inputs(T * 10 + N, T, N, trailing, done_dtype)
    want_ret, want_adv = _jax(backend, rewards, values, dones, next_value, 0.99, 0.95)
    args = [torch.from_numpy(a) for a in (rewards, values, dones, next_value)]
    ret, adv = K.gae_reference(*args, 0.99, 0.95)
    assert ret.dtype == adv.dtype == torch.float32 and ret.shape == adv.shape == rewards.shape
    np.testing.assert_allclose(ret.numpy(), want_ret, **TOL)
    np.testing.assert_allclose(adv.numpy(), want_adv, **TOL)
    w_ret, w_adv = K.gae(*args, 0.99, 0.95)  # a CPU tensor takes the plain version
    assert torch.equal(w_ret, ret) and torch.equal(w_adv, adv)


@pytest.mark.parametrize("gamma, lam", [(0.9, 0.8), (1.0, 1.0), (0.997, 0.0)])
def test_torch_gae_other_discounts_match_jax(gamma, lam):
    rewards, values, dones, next_value = _inputs(3, 32, 5)
    want = _jax("pallas", rewards, values, dones, next_value, gamma, lam)
    got = K.gae(*(torch.from_numpy(a) for a in (rewards, values, dones, next_value)), gamma, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_torch_gae_bf16_inputs_match_jax(backend):
    rewards, values, dones, next_value = _inputs(4, 24, 6)
    want = _jax(backend, rewards, values, dones, next_value, 0.99, 0.95, dtype=jnp.bfloat16)
    as_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (rewards, values, next_value)]
    got = K.gae(as_bf16[0], as_bf16[1], torch.from_numpy(dones), as_bf16[2], 0.99, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def _jax_grads(rewards, values, dones, next_value, w_ret, w_adv):
    def loss(r, v, nv):
        ret, adv = JK.gae(r, v, jnp.asarray(dones), nv, 0.99, 0.95, backend="pallas")
        return jnp.sum(ret * w_ret) + jnp.sum(adv * w_adv)

    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a) for a in (rewards, values, next_value)))]


def _torch_grads(fn, rewards, values, dones, next_value, w_ret, w_adv):
    r, v, nv = (torch.from_numpy(a).requires_grad_(True) for a in (rewards, values, next_value))
    ret, adv = fn(r, v, torch.from_numpy(dones), nv)
    ((ret * torch.from_numpy(w_ret)).sum() + (adv * torch.from_numpy(w_adv)).sum()).backward()
    return [t.grad.numpy() for t in (r, v, nv)]


def test_torch_gae_gradients_match_jax(monkeypatch):
    rewards, values, dones, next_value = _inputs(5, 20, 6)
    rng = np.random.default_rng(6)
    w_ret, w_adv = (rng.uniform(0.5, 2.0, size=rewards.shape).astype(np.float32) for _ in range(2))
    want = _jax_grads(rewards, values, dones, next_value, w_ret, w_adv)
    plain = _torch_grads(lambda *a: K.gae(*a, 0.99, 0.95), rewards, values, dones, next_value, w_ret, w_adv)
    for g, w in zip(plain, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    # the autograd.Function the card runs, with the plain forward in place of the launch
    monkeypatch.setattr(gae_module, "_launch", gae_module.gae_reference)
    function = _torch_grads(
        lambda *a: gae_module._Gae.apply(*a, 0.99, 0.95), rewards, values, dones, next_value, w_ret, w_adv
    )
    for g, w in zip(function, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_torch_gae_function_backward_skips_inputs_without_grad(monkeypatch):
    monkeypatch.setattr(gae_module, "_launch", gae_module.gae_reference)
    rewards, values, dones, next_value = (torch.from_numpy(a) for a in _inputs(7, 6, 3))
    v = values.clone().requires_grad_(True)
    ret, adv = gae_module._Gae.apply(rewards, v, dones, next_value, 0.99, 0.95)
    (ret.sum() + adv.sum()).backward()
    assert v.grad is not None and rewards.grad is None and next_value.grad is None


def test_torch_gae_wrapper_raises_off_the_cpu_without_a_card():
    """A tensor that is not on the CPU goes to the kernel, which takes only
    CUDA tensors: no quiet fallback to the plain version."""
    z = torch.zeros((4, 2, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.gae(z, z, z.to(torch.uint8), torch.zeros((2, 1), device="meta"), 0.99, 0.95)
    assert K.LAUNCHES["gae"] == 0
