"""The population's GAE entry, ``gae_factors`` (per-member ``(P,)`` gamma and
lambda over a ``(T, P, ...)`` rollout), against the JAX package's on the CPU.

The JAX population calls its GAE under ``vmap`` with traced float32 factors
(``ppo_anakin_population.py:504`` -> ``ppo_anakin.py:185``). The port's plain
version (what the wrapper runs on CPU tensors and what the CUDA entry
``gae_launch_factors`` is held against on the card) is compared with JAX's
lax reference vmapped over members, within atol 5e-6 and rtol 1e-6: XLA
fuses the vmapped recurrence's multiply-adds, one rounding fewer per step,
and over the main path's 128 steps that reaches 1.9e-6 on advantages of
~0.4 (the unvmapped scalar comparison, ``test_torch_gae.py``, holds 1e-6).

The rounding of ``gamma * lambda`` is held exactly: with a reward of 2^20 at
the last step and zeros elsewhere, the first step's advantage is
``gamma * lambda * 2^20``, exact on both sides whatever fuses, so it reads the
factor. The population rounds the float32 product of its float32 factors
(JAX's traced product); the scalar entry rounds the product of the Python
doubles once (JAX's weak-typed product). At gamma 0.98, lambda 0.9 the two
differ by one ulp; at the recipes' 0.99, 0.95 they agree, so a
one-member population equals the single run bit for bit."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.core import gae as jax_gae
from sheeprl_tpu_torch.ops import kernels as K

gae_module = importlib.import_module("sheeprl_tpu_torch.ops.kernels.gae")
TOL = dict(atol=5e-6, rtol=1e-6)
FACTORS = {1: ([0.99], [0.95]), 2: ([0.99, 0.98], [0.95, 0.9]), 8: (
    [0.99, 0.98, 0.97, 0.995, 0.9, 0.999, 0.95, 0.99], [0.95, 0.9, 0.92, 0.8, 0.95, 0.99, 0.5, 0.0])}


def _inputs(seed, T, P, N, trailing=(1,)):
    rng = np.random.default_rng(seed)
    shape = (T, P, N) + trailing
    rewards = rng.normal(size=shape).astype(np.float32)
    values = (rng.normal(size=shape) * 3).astype(np.float32)
    dones = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    if T > 2:
        dones[T // 2, :, 0] = 1.0
    next_value = rng.normal(size=shape[1:]).astype(np.float32)
    return rewards, values, dones, next_value


def _jax_vmapped(rewards, values, dones, next_value, gamma, lam):
    """JAX's lax GAE vmapped over the member axis with traced factors, as the
    population block calls it."""
    fn = jax.jit(jax.vmap(jax_gae, in_axes=(1, 1, 1, 0, 0, 0), out_axes=1))
    ret, adv = fn(rewards, values, dones, next_value, jnp.asarray(gamma, jnp.float32), jnp.asarray(lam, jnp.float32))
    return np.asarray(ret), np.asarray(adv)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("trailing", [(1,), ()], ids=["TPN1", "TPN"])
@pytest.mark.parametrize("T, N", [(16, 4), (128, 4), (1, 3)], ids=["T16", "main-path", "T1"])
def test_torch_population_gae_matches_jax_vmap(P, trailing, T, N):
    gamma, lam = (np.asarray(x, np.float32) for x in FACTORS[P])
    arrays = _inputs(T * 7 + P, T, P, N, trailing)
    want_ret, want_adv = _jax_vmapped(*arrays, gamma, lam)
    ret, adv = K.gae_factors(*_torch(*arrays, gamma, lam))
    assert ret.dtype == adv.dtype == torch.float32 and ret.shape == adv.shape == arrays[0].shape
    np.testing.assert_allclose(ret.numpy(), want_ret, **TOL)
    np.testing.assert_allclose(adv.numpy(), want_adv, **TOL)


def _factor_probe(P):
    """Rewards 2^20 at the last of two steps, everything else 0: the first
    step's advantage is gamma * lambda * 2^20 exactly."""
    rewards = np.zeros((2, P, 1, 1), np.float32)
    rewards[1] = 2.0**20
    zeros = np.zeros_like(rewards)
    return rewards, zeros, zeros, np.zeros((P, 1, 1), np.float32)


def test_torch_population_gae_rounds_gamma_lambda_in_float32():
    gamma, lam = np.asarray([0.98, 0.99], np.float32), np.asarray([0.9, 0.95], np.float32)
    probe = _factor_probe(2)
    _, adv = K.gae_factors(*_torch(*probe, gamma, lam))
    read = adv[0, :, 0, 0].numpy() / np.float32(2.0**20)
    f32_product = gamma * lam
    double_product = np.asarray([np.float32(0.98 * 0.9), np.float32(0.99 * 0.95)])
    np.testing.assert_array_equal(read, f32_product)
    assert read[0] != double_product[0]  # 0.98 x 0.9: the two roundings differ by one ulp
    assert read[1] == double_product[1]  # the recipe's 0.99 x 0.95: they agree
    # JAX's vmapped population reads the same float32 product, bit for bit
    _, jax_adv = _jax_vmapped(*probe, gamma, lam)
    np.testing.assert_array_equal(adv.numpy(), jax_adv)
    # the scalar entry keeps the single run's double product
    for m, (g, lm) in enumerate([(0.98, 0.9), (0.99, 0.95)]):
        _, single = K.gae(*_torch(probe[0][:, m], probe[1][:, m], probe[2][:, m], probe[3][m]), g, lm)
        assert single[0, 0, 0].item() / 2.0**20 == double_product[m]


@pytest.mark.parametrize("T", [16, 128])
def test_torch_population_gae_members_equal_the_scalar_entry(T):
    """At the recipe's factors every member's columns are the scalar entry's
    on that member's rollout, bit for bit: P = 1 included."""
    for P in (1, 3):
        arrays = _inputs(T + P, T, P, 4)
        ret, adv = K.gae_factors(*_torch(*arrays, np.full(P, 0.99, np.float32), np.full(P, 0.95, np.float32)))
        for m in range(P):
            s_ret, s_adv = K.gae(*_torch(arrays[0][:, m], arrays[1][:, m], arrays[2][:, m], arrays[3][m]), 0.99, 0.95)
            assert torch.equal(ret[:, m], s_ret) and torch.equal(adv[:, m], s_adv)


def test_torch_population_gae_checks_its_factors():
    arrays = _torch(*_inputs(0, 4, 2, 3))
    with pytest.raises(ValueError, match="gae_factors wants"):
        K.gae_factors(*arrays, torch.full((3,), 0.99), torch.full((3,), 0.95))
    with pytest.raises(ValueError, match="gae_factors wants"):
        K.gae_factors(*arrays, torch.tensor(0.99), torch.tensor(0.95))


def _launch_as_plain(monkeypatch):
    def plain(rewards, values, dones, next_value, gamma, lam):
        K.LAUNCHES["gae"] += 1
        return K.gae_factors_reference(rewards, values, dones, next_value, gamma, lam)

    monkeypatch.setattr(gae_module, "_launch_factors", plain)


def test_torch_population_gae_cpu_tensors_take_the_plain_version():
    K.reset_launches()
    arrays = _torch(*_inputs(1, 8, 2, 3), np.full(2, 0.99, np.float32), np.full(2, 0.95, np.float32))
    got = K.gae_factors(*arrays)
    want = K.gae_factors_reference(*arrays)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.LAUNCHES["gae"] == 0


def test_torch_population_gae_gradient_matches_jax(monkeypatch):
    """The card's ``autograd.Function`` (its launch stood in by the plain
    version) differentiates through the plain chain: gradients of a weighted
    sum of both outputs against ``jax.grad`` of the vmapped reference within
    1e-5."""
    _launch_as_plain(monkeypatch)
    P, T, N = 2, 16, 3
    gamma, lam = (np.asarray(x, np.float32) for x in FACTORS[P])
    rewards, values, dones, next_value = _inputs(5, T, P, N)
    rng = np.random.default_rng(9)
    w_ret, w_adv = rng.normal(size=rewards.shape).astype(np.float32), rng.normal(size=rewards.shape).astype(np.float32)

    def jax_loss(r, v, nv):
        fn = jax.vmap(jax_gae, in_axes=(1, 1, 1, 0, 0, 0), out_axes=1)
        ret, adv = fn(r, v, dones, nv, jnp.asarray(gamma), jnp.asarray(lam))
        return (ret * w_ret).sum() + (adv * w_adv).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(rewards, values, next_value)
    leaves = [t.requires_grad_(True) for t in _torch(rewards, values, next_value)]
    K.reset_launches()
    ret, adv = gae_module._GaeFactors.apply(leaves[0], leaves[1], torch.from_numpy(dones), leaves[2],
                                            *_torch(gamma, lam))
    assert K.LAUNCHES["gae"] == 1
    ((ret * torch.from_numpy(w_ret)).sum() + (adv * torch.from_numpy(w_adv)).sum()).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
