"""The port's two-hot kernels (``sheeprl_tpu_torch/ops/kernels/twohot.py``)
against the JAX package's, on the CPU.

Inputs are numpy from a seed at K in {17, 255}: log-normalised logits, and
targets that include 0, negatives, a target whose symlog lands exactly on a
bin, and targets beyond +-20 in symlog space (clipped brackets). The port's
plain versions (what its wrappers run on CPU tensors, and what the CUDA
kernels are held against on the card) are compared with the JAX kernels run
through their Pallas bodies in interpret mode and through their lax
references:

- float32 within atol 1e-5, rtol 1e-5: the Pallas kernels rebuild the bins
  from an iota, ``linspace`` differs by at most 1 ulp, and the two-hot
  weights are continuous in the bins;
- bf16 logits: the Pallas kernels widen to float32 inside, as the CUDA
  kernels do, so their result is held against the port's plain version in
  float32 on the same bf16-rounded logits, within atol 2e-2 (one bf16
  rounding of the output);
- gradients for ``logits`` and ``value`` against ``jax.grad`` within atol
  1e-5, both through the wrappers' CPU path and through the
  ``autograd.Function``s the card uses (their launch swapped for the plain
  version, since the kernels run only on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import kernels as JK
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.ops.kernels import twohot

BINS = [17, 255]


def _logits(rng, n, k):
    x = rng.normal(size=(n, k)).astype(np.float32) * 2
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _on_bin(k):
    """A float32 target whose float32 symlog is exactly bin 3/4 of the way up."""
    b = np.linspace(-20.0, 20.0, k, dtype=np.float32)[(3 * (k - 1)) // 4]
    v = np.float32(np.expm1(np.float64(b)))
    for _ in range(64):
        s = np.float32(np.log1p(np.float32(abs(v))))
        if s == b:
            break
        v = np.nextafter(v, np.float32(np.inf) if s < b else np.float32(-np.inf), dtype=np.float32)
    return v


def _values(rng, n, k):
    v = (rng.normal(size=(n, 1)) * 30).astype(np.float32)
    special = [0.0, -1.0, -250.0, 3.5, _on_bin(k), 1e10, -1e10, np.float32(np.expm1(20.0))]
    v[: len(special), 0] = special
    return v


@pytest.mark.parametrize("k", BINS)
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_torch_twohot_symlog_loss_matches_jax(k, backend):
    rng = np.random.default_rng(k)
    logits, value = _logits(rng, 40, k), _values(rng, 40, k)
    want = np.asarray(JK.two_hot_symlog_loss(jnp.asarray(logits), jnp.asarray(value), backend=backend))
    plain = K.two_hot_symlog_loss_reference(torch.from_numpy(logits), torch.from_numpy(value)).numpy()
    wrapped = K.two_hot_symlog_loss(torch.from_numpy(logits), torch.from_numpy(value)).numpy()
    assert plain.shape == want.shape == (40,)
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(wrapped, plain)  # a CPU tensor takes the plain version


@pytest.mark.parametrize("k", BINS)
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_torch_twohot_symexp_decode_matches_jax(k, backend):
    rng = np.random.default_rng(100 + k)
    logits = _logits(rng, 40, k) * 3
    want = np.asarray(JK.two_hot_symexp_decode(jnp.asarray(logits), backend=backend))
    plain = K.two_hot_symexp_decode_reference(torch.from_numpy(logits)).numpy()
    wrapped = K.two_hot_symexp_decode(torch.from_numpy(logits)).numpy()
    assert plain.shape == want.shape == (40, 1)
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("k", BINS)
def test_torch_twohot_bf16_logits_match_the_pallas_kernels(k):
    rng = np.random.default_rng(200 + k)
    logits = jnp.asarray(_logits(rng, 24, k), dtype=jnp.bfloat16)
    value = _values(rng, 24, k)
    as_f32 = torch.from_numpy(np.array(logits.astype(jnp.float32)))
    got = np.asarray(JK.two_hot_symlog_loss(logits, jnp.asarray(value, dtype=jnp.bfloat16), backend="pallas"))
    value_f32 = np.array(jnp.asarray(value, dtype=jnp.bfloat16).astype(jnp.float32))
    want = K.two_hot_symlog_loss_reference(as_f32, torch.from_numpy(value_f32)).numpy()
    np.testing.assert_allclose(got.astype(np.float32), want, atol=2e-2, rtol=1e-2)
    got = np.asarray(JK.two_hot_symexp_decode(logits, backend="pallas"))
    want = K.two_hot_symexp_decode_reference(as_f32).numpy()
    np.testing.assert_allclose(got.astype(np.float32), want, atol=2e-2, rtol=1e-2)


def _jax_grads(logits, value, w):
    # a fixed weighting of the outputs, so the backward sees an upstream
    # gradient other than ones
    loss = jax.grad(lambda lg, v: jnp.sum(JK.two_hot_symlog_loss(lg, v, backend="pallas") * w[:, 0]), (0, 1))
    decode = jax.grad(lambda lg: jnp.sum(JK.two_hot_symexp_decode(lg, backend="pallas") * w))
    gl, gv = loss(jnp.asarray(logits), jnp.asarray(value))
    return np.asarray(gl), np.asarray(gv), np.asarray(decode(jnp.asarray(logits)))


def _torch_grads(logits, value, w, loss_fn, decode_fn):
    lg = torch.from_numpy(logits).requires_grad_(True)
    v = torch.from_numpy(value).requires_grad_(True)
    w = torch.from_numpy(w)
    (loss_fn(lg, v) * w[:, 0]).sum().backward()
    gl, gv = lg.grad.numpy().copy(), v.grad.numpy().copy()
    lg.grad = None
    (decode_fn(lg) * w).sum().backward()
    return gl, gv, lg.grad.numpy()


@pytest.mark.parametrize("k", BINS)
def test_torch_twohot_gradients_match_jax(k, monkeypatch):
    rng = np.random.default_rng(300 + k)
    logits, value = _logits(rng, 16, k), _values(rng, 16, k)
    value[:8, 0] = (rng.normal(size=8) * 4).astype(np.float32)  # inside the support, where d/dvalue != 0
    w = rng.uniform(0.5, 2.0, size=(16, 1)).astype(np.float32)
    want = _jax_grads(logits, value, w)
    # the wrappers' CPU path
    got = _torch_grads(logits, value, w, K.two_hot_symlog_loss, K.two_hot_symexp_decode)
    for g, expected in zip(got, want):
        np.testing.assert_allclose(g, expected, atol=1e-5, rtol=1e-5)
    # the autograd.Functions the card runs, with the plain forward in place of the launch
    monkeypatch.setattr(twohot, "_launch_loss", twohot.two_hot_symlog_loss_reference)
    monkeypatch.setattr(twohot, "_launch_decode", twohot.two_hot_symexp_decode_reference)
    got = _torch_grads(
        logits, value, w,
        lambda lg, v: twohot._TwoHotSymlogLoss.apply(lg, v, -20.0, 20.0),
        lambda lg: twohot._TwoHotSymexpDecode.apply(lg, -20.0, 20.0),
    )
    for g, expected in zip(got, want):
        np.testing.assert_allclose(g, expected, atol=1e-5, rtol=1e-5)


def test_torch_twohot_function_backward_skips_inputs_without_grad(monkeypatch):
    monkeypatch.setattr(twohot, "_launch_loss", twohot.two_hot_symlog_loss_reference)
    lg = torch.zeros((3, 17)).log_softmax(-1).requires_grad_(True)
    v = torch.tensor([[1.0], [2.0], [-3.0]])
    twohot._TwoHotSymlogLoss.apply(lg, v, -20.0, 20.0).sum().backward()
    assert lg.grad is not None and v.grad is None


def test_torch_twohot_wrappers_raise_off_the_cpu_without_a_card():
    """A tensor that is not on the CPU goes to the kernel, which takes only
    CUDA tensors: no quiet fallback to the plain version."""
    logits = torch.zeros((4, 17), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.two_hot_symexp_decode(logits)
    with pytest.raises(ValueError, match="CUDA"):
        K.two_hot_symlog_loss(logits, torch.zeros((4, 1), device="meta"))
