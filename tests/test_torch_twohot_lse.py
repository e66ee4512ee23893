"""The fused two-hot loss over raw logits (``two_hot_symlog_loss_lse``), its
backward, and ``TwoHotEncodingDistribution`` built on them, against the JAX
package's distribution on the CPU.

The port's distribution keeps the head's raw logits: ``log_prob`` calls
:func:`two_hot_symlog_loss_lse`, the log-normalisation fused into the loss
kernel (with a backward kernel) on the card, and ``mean`` calls
:func:`two_hot_mean`, the decode kernel on the raw logits there. On CPU
tensors both run the JAX package's ops, the normalisation first. Inputs are
numpy from a seed at K in {17, 255}, raw logits off centre, and the special
targets of ``tests/test_torch_twohot.py`` (0, negatives, a target whose
symlog lands exactly on a bin, targets beyond +-20 in symlog space).

Tolerances: ``log_prob``, ``mean`` and their gradients against JAX within
atol and rtol 1e-5 (the Pallas kernels rebuild the bins from an iota, 1 ulp
from ``linspace``, and the two-hot weights are continuous in the bins; JAX
sums in another order). The backward kernel's plain version against autograd
of the plain chain within 1e-6: the same terms, ``g * w`` summed before or
after the product with the softmax. The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``); here the ``autograd.Function``
runs with its two launches stood in by their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.ops.kernels import registry as jax_registry
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.ops.kernels import _build
from sheeprl_tpu_torch.ops.kernels import twohot
from tests.test_torch_twohot import _values

BINS = [17, 255]
ATOL = RTOL = 1e-5


def _raw_logits(rng, shape, scale=3.0):
    """Head outputs: spread and off centre, so the normalisation matters."""
    return (rng.normal(size=shape) * scale + 1.5).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _plain_launches(monkeypatch):
    """The Function's two launches stood in by their plain versions."""
    def forward(logits, value, low, high):
        return twohot.two_hot_symlog_loss_lse_reference(logits, value, low, high), torch.logsumexp(logits, dim=-1)

    monkeypatch.setattr(twohot, "_launch_loss_lse", forward)
    monkeypatch.setattr(twohot, "_launch_loss_lse_bwd", twohot.two_hot_symlog_loss_lse_grad_reference)


@pytest.mark.parametrize("k", BINS)
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_torch_twohot_lse_distribution_matches_jax(k, backend):
    """``log_prob`` and ``mean`` of the port's distribution on raw logits
    against JAX's ``TwoHotEncodingDistribution`` (its Pallas kernels in
    interpret mode, or its lax references): atol and rtol 1e-5."""
    rng = np.random.default_rng(k)
    logits, value = _raw_logits(rng, (40, k)), _values(rng, 40, k)
    with jax_registry.use_backend(backend):
        jd = JD.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1)
        want_lp, want_mean = np.asarray(jd.log_prob(jnp.asarray(value))), np.asarray(jd.mean)
    td = TD.TwoHotEncodingDistribution(_t(logits))
    got_lp, got_mean = td.log_prob(_t(value)).numpy(), td.mean.numpy()
    assert got_lp.shape == want_lp.shape == (40,) and got_mean.shape == want_mean.shape == (40, 1)
    np.testing.assert_allclose(got_lp, want_lp, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_mean, want_mean, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(td.logits.numpy(), np.asarray(jd.logits), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", BINS)
def test_torch_twohot_lse_cpu_ops_are_the_normalisation_then_the_plain_chain(k):
    """On CPU tensors the fused entry and the distribution run exactly the
    ops of the unfused chain: the normalised logits, then the unfused plain
    loss and decode (bit-equal)."""
    rng = np.random.default_rng(50 + k)
    logits, value = _t(_raw_logits(rng, (3, 5, k))), _t(_values(rng, 15, k).reshape(3, 5, 1))
    normalised = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    want = K.two_hot_symlog_loss_reference(normalised, value)
    torch.testing.assert_close(K.two_hot_symlog_loss_lse(logits, value), want, atol=0, rtol=0)
    torch.testing.assert_close(K.two_hot_symlog_loss_lse_reference(logits, value), want, atol=0, rtol=0)
    td = TD.TwoHotEncodingDistribution(logits)
    torch.testing.assert_close(td.log_prob(value), want, atol=0, rtol=0)
    torch.testing.assert_close(td.mean, K.two_hot_symexp_decode_reference(normalised), atol=0, rtol=0)
    torch.testing.assert_close(K.two_hot_mean(logits), td.mean, atol=0, rtol=0)


@pytest.mark.parametrize("k", BINS)
def test_torch_twohot_lse_bf16_raw_logits_match_the_pallas_kernels(k):
    """bf16 raw logits through JAX's distribution (Pallas kernels in
    interpret mode, f32 inside) against the port's plain versions in f32 on
    the same bf16-rounded logits: atol 2e-2, rtol 1e-2 (bf16 roundings of
    the normalised logits and of the output)."""
    rng = np.random.default_rng(150 + k)
    logits = jnp.asarray(_raw_logits(rng, (24, k)), dtype=jnp.bfloat16)
    value = _values(rng, 24, k)
    as_f32 = _t(np.asarray(logits.astype(jnp.float32)))
    with jax_registry.use_backend("pallas"):
        jd = JD.TwoHotEncodingDistribution(logits, dims=1)
        got_lp = np.asarray(jd.log_prob(jnp.asarray(value, dtype=jnp.bfloat16))).astype(np.float32)
        got_mean = np.asarray(jd.mean).astype(np.float32)
    value_f32 = _t(np.asarray(jnp.asarray(value, dtype=jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_allclose(got_lp, K.two_hot_symlog_loss_lse_reference(as_f32, value_f32).numpy(),
                               atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got_mean, K.two_hot_mean(as_f32).numpy(), atol=2e-2, rtol=1e-2)


def _jax_vjp(logits, value, cot, backend):
    def log_prob(lg, v):
        return JD.TwoHotEncodingDistribution(lg, dims=1).log_prob(v)

    with jax_registry.use_backend(backend):
        _, vjp = jax.vjp(log_prob, jnp.asarray(logits), jnp.asarray(value))
        return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


ON_BIN = 4  # the row of _values whose symlog lands exactly on a bin


@pytest.mark.parametrize("k", BINS)
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_torch_twohot_lse_function_gradients_match_jax_vjp(monkeypatch, k, backend):
    """The gradients for the raw logits and the value through the
    ``autograd.Function`` the card runs (its forward and backward launches
    stood in by their plain versions) against ``jax.vjp`` of JAX's
    ``log_prob``, under an upstream gradient other than ones: atol and rtol
    1e-5. At the target on a bin the value's gradient sits on the kink of
    ``|bin - x|``, whose derivative at 0 each framework defines for itself
    (JAX 1, PyTorch 0): that row is held to the plain PyTorch chain's
    instead, bit for bit."""
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(300 + k)
    logits, value = _raw_logits(rng, (16, k)), _values(rng, 16, k)
    value[8:, 0] = (rng.normal(size=8) * 4).astype(np.float32)  # inside the support, where d/dvalue != 0
    cot = rng.uniform(0.5, 2.0, size=16).astype(np.float32)
    want_logits, want_value = _jax_vjp(logits, value, cot, backend)
    off_kink = np.arange(16) != ON_BIN
    grads = []
    for fn in (lambda lg, v: twohot._TwoHotSymlogLossLse.apply(lg, v, -20.0, 20.0), K.two_hot_symlog_loss_lse):
        lg, v = _t(logits, grad=True), _t(value, grad=True)
        fn(lg, v).backward(_t(cot))  # the Function, then the wrapper's CPU path (the plain chain under autograd)
        np.testing.assert_allclose(lg.grad.numpy(), want_logits, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(v.grad.numpy()[off_kink], want_value[off_kink], atol=ATOL, rtol=RTOL)
        grads.append(v.grad[ON_BIN])
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)


@pytest.mark.parametrize("k", BINS)
@pytest.mark.parametrize("shape", [(16,), (3, 5)], ids=["rows", "batched"])
def test_torch_twohot_lse_grad_reference_matches_autograd_of_the_plain_chain(k, shape):
    """The backward kernel's plain version against autograd of the plain
    chain (``logits - logsumexp``, then the plain loss), for the raw logits:
    atol and rtol 1e-6."""
    rng = np.random.default_rng(400 + k + len(shape))
    n = int(np.prod(shape))
    logits = _t(_raw_logits(rng, (*shape, k)), grad=True)
    value = _t(_values(rng, n, k).reshape(*shape, 1))
    cot = _t(rng.normal(size=shape).astype(np.float32))
    K.two_hot_symlog_loss_lse_reference(logits, value).backward(cot)
    with torch.no_grad():
        got = K.two_hot_symlog_loss_lse_grad_reference(logits, value, torch.logsumexp(logits, dim=-1), cot)
    assert got.shape == logits.shape and got.dtype == logits.dtype
    torch.testing.assert_close(got, logits.grad, atol=1e-6, rtol=1e-6)


def test_torch_twohot_lse_frozen_value_gets_no_gradient(monkeypatch):
    """A value that does not require grad gets none, and its plain-chain
    branch does not run; frozen logits get none either."""
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(7)
    logits, value = _raw_logits(rng, (6, 17)), _values(rng, 8, 17)[:6]
    ran = []
    real = twohot._plain_grads
    monkeypatch.setattr(twohot, "_plain_grads", lambda *a: ran.append(1) or real(*a))
    lg, v = _t(logits, grad=True), _t(value)
    twohot._TwoHotSymlogLossLse.apply(lg, v, -20.0, 20.0).sum().backward()
    assert lg.grad is not None and v.grad is None and ran == []
    lg, v = _t(logits), _t(value, grad=True)
    twohot._TwoHotSymlogLossLse.apply(lg, v, -20.0, 20.0).sum().backward()
    assert lg.grad is None and v.grad is not None and ran == [1]


@pytest.mark.parametrize("function", ["lse", "pr2"])
def test_torch_twohot_lse_backward_releases_its_saved_tensors(monkeypatch, function):
    """After one backward the Function's node holds none of its saved
    tensors (logits, value and, for the fused loss, the rows' lse), though
    the output that owns the node lives on, as a logged loss does."""
    _plain_launches(monkeypatch)
    monkeypatch.setattr(twohot, "_launch_loss", twohot.two_hot_symlog_loss_reference)
    rng = np.random.default_rng(8)
    lg, v = _t(_raw_logits(rng, (8, 17)), grad=True), _t(_values(rng, 8, 17))
    fn = twohot._TwoHotSymlogLossLse if function == "lse" else twohot._TwoHotSymlogLoss
    out = fn.apply(lg, v, -20.0, 20.0)
    assert len(out.grad_fn.saved_tensors) == (3 if function == "lse" else 2)
    out.sum().backward()
    with pytest.raises(RuntimeError, match="freed"):
        out.grad_fn.saved_tensors


@pytest.mark.parametrize("k", BINS)
def test_torch_twohot_mean_of_raw_logits_through_the_decode_function_matches_jax(monkeypatch, k):
    """On the card ``mean`` hands the raw logits to the decode kernel (its
    launch stood in here by the plain decode, which it matches on the card):
    the result equals JAX's mean of the normalised logits within 1e-5."""
    monkeypatch.setattr(twohot, "_launch_decode", twohot.two_hot_symexp_decode_reference)
    rng = np.random.default_rng(500 + k)
    logits = _raw_logits(rng, (40, k), scale=1.0)
    want = np.asarray(JD.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1).mean)
    got = twohot._TwoHotSymexpDecode.apply(_t(logits), -20.0, 20.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_torch_twohot_lse_cpu_path_launches_nothing():
    rng = np.random.default_rng(9)
    before = dict(K.LAUNCHES)
    lg = _t(_raw_logits(rng, (8, 255)), grad=True)
    td = TD.TwoHotEncodingDistribution(lg)
    (td.log_prob(_t(_values(rng, 8, 255))).sum() + td.mean.sum()).backward()
    assert K.LAUNCHES == before and lg.grad is not None


def test_torch_twohot_lse_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernels, which take only CUDA
    tensors and raise: no quiet fallback to the plain version."""
    logits, value = torch.zeros((4, 17), device="meta"), torch.zeros((4, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.two_hot_symlog_loss_lse(logits, value)
    with pytest.raises(ValueError, match="CUDA"):
        K.two_hot_symlog_loss_lse(logits, torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        K.two_hot_mean(logits)
    td = TD.TwoHotEncodingDistribution(logits)
    with pytest.raises(ValueError, match="CUDA"):
        td.log_prob(value)
    with pytest.raises(ValueError, match="CUDA"):
        td.mean


def test_torch_twohot_lse_missing_nvcc_is_a_named_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        twohot._library()
