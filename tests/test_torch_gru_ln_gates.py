"""The port's fused LayerNorm + GRU gate chain against the JAX package's.

The RSSM cell's epilogue in the JAX package is flax ``nn.LayerNorm`` on the
``(B, 3H)`` projection followed by ``gru_gates`` (its Pallas kernel, here in
interpret mode). The port computes both in one CUDA kernel,
:func:`gru_gates_ln`; on the CPU its wrapper runs the plain version
:func:`gru_gates_ln_reference`, which these tests hold against the JAX chain,
forward and backward. The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``); here the tests show that a non-CPU
tensor never reaches the plain version, that a missing compiler is a named
error, and that the cell and its checkpoints are those of the unfused cell.

Tolerance: atol 1e-5 (rtol 1e-5 on gradients). flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 and torch's in two passes, which differ by about
1e-6 relative; the gate chain is the same float32 arithmetic on both sides.
"""

import io

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sheeprl_tpu.ops.kernels import gru as jax_gru
from sheeprl_tpu.ops.kernels import registry as jax_registry
from sheeprl_tpu_torch.algos.dreamer_v3.agent import RecurrentModel
from sheeprl_tpu_torch.models import LayerNormGRUCell
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.ops.kernels import _build
from sheeprl_tpu_torch.ops.kernels import gru as torch_gru

EPS = 1e-3  # the RSSM cell's LayerNorm epsilon, in both packages
ATOL = 1e-5


def _inputs(B, H, seed=0):
    """A projection off centre and spread (as a Linear's output is), the
    carry, and a non-trivial affine, so the scale -> weight mapping counts."""
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(B, 3 * H)) * 2.0 + 0.5).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    weight = (1.0 + 0.3 * rng.normal(size=(3 * H,))).astype(np.float32)
    bias = (0.2 * rng.normal(size=(3 * H,))).astype(np.float32)
    return proj, h, weight, bias


def _jax_chain(proj, h, scale, bias):
    y = fnn.LayerNorm(epsilon=EPS).apply({"params": {"scale": scale, "bias": bias}}, proj)
    return jax_gru.gru_gates(y, h)


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("B", [1, 5, 32, 300])
@pytest.mark.parametrize("H", [8, 16, 64])
def test_torch_gru_ln_reference_matches_jax_layernorm_and_pallas_gates(B, H):
    """flax LayerNorm then the Pallas gate chain (interpret mode) against
    the port's plain version and its wrapper on CPU tensors: atol 1e-5."""
    proj, h, weight, bias = _inputs(B, H, seed=B + H)
    with jax_registry.use_backend("pallas"):
        want = np.asarray(_jax_chain(*(jnp.asarray(a) for a in (proj, h, weight, bias))))
    plain = K.gru_gates_ln_reference(*_torch(proj, h, weight, bias), EPS).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=ATOL)
    got = K.gru_gates_ln(*_torch(proj, h, weight, bias), EPS).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("shape", [(1, 8), (5, 16), (32, 64)], ids=["B1", "odd-batch", "serve-bucket"])
def test_torch_gru_ln_backward_matches_jax_vjp(monkeypatch, shape):
    """The autograd.Function's backward (the plain chain re-derived) for all
    four inputs against ``jax.vjp`` of the JAX chain: atol and rtol 1e-5.
    The launch is stood in by the plain version, since no CUDA kernel runs
    here; what is under test is the backward."""
    monkeypatch.setattr(torch_gru, "_launch_ln", lambda p, h, w, b, eps: torch_gru.gru_gates_ln_reference(p, h, w, b, eps))
    proj, h, weight, bias = _inputs(*shape, seed=7)
    cot = np.random.default_rng(8).normal(size=h.shape).astype(np.float32)
    leaves = _torch(proj, h, weight, bias, grad=True)
    out = torch_gru._GruGatesLn.apply(*leaves, EPS)
    out.backward(torch.from_numpy(cot))
    with jax_registry.use_backend("pallas"):
        _, vjp = jax.vjp(_jax_chain, *(jnp.asarray(a) for a in (proj, h, weight, bias)))
        want = vjp(jnp.asarray(cot))
    for name, leaf, w in zip(("proj", "h", "weight", "bias"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL, err_msg=name)


def test_torch_gru_ln_backward_returns_only_the_gradients_asked_for(monkeypatch):
    """A frozen affine gets no gradient, and the projection's and the
    carry's are those of the plain chain (exact: the same ops)."""
    monkeypatch.setattr(torch_gru, "_launch_ln", lambda p, h, w, b, eps: torch_gru.gru_gates_ln_reference(p, h, w, b, eps))
    proj, h, weight, bias = _inputs(4, 8, seed=9)
    grads = []
    for fn in (lambda *a: torch_gru._GruGatesLn.apply(*a, EPS), lambda *a: K.gru_gates_ln_reference(*a, EPS)):
        p, hh = _torch(proj, h, grad=True)
        w, b = _torch(weight, bias)
        (fn(p, hh, w, b) ** 2).sum().backward()
        assert w.grad is None and b.grad is None
        grads.append((p.grad, hh.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_torch_gru_ln_bf16_plain_version_keeps_the_dtype():
    """The bf16 entry takes the float32 affine (the parameter dtype) and
    keeps the carry's dtype."""
    proj, h, weight, bias = _torch(*_inputs(3, 8))
    assert K.gru_gates_ln(proj.bfloat16(), h.bfloat16(), weight, bias, EPS).dtype == torch.bfloat16


def test_torch_gru_ln_cpu_path_launches_nothing():
    before = dict(K.LAUNCHES)
    K.gru_gates_ln(*_torch(*_inputs(4, 8)), EPS)
    LayerNormGRUCell(6, 8, use_bias=False, layer_norm=True)(torch.zeros(2, 8), torch.zeros(2, 6))
    assert K.LAUNCHES == before


def test_torch_gru_ln_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which checks its device
    and raises: there is no fallback to the plain version."""
    meta = [torch.empty(s, device="meta") for s in ((2, 12), (2, 4), (12,), (12,))]
    with pytest.raises(ValueError, match="CUDA device"):
        K.gru_gates_ln(*meta, EPS)
    cpu = _torch(*_inputs(2, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        K.gru_gates_ln(cpu[0], cpu[1], meta[2], meta[3], EPS)


def test_torch_gru_ln_missing_nvcc_is_a_named_build_error(monkeypatch, tmp_path):
    """The fused entry lives in the gates' library: without nvcc, building
    it is a KernelBuildError that names the compiler."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        torch_gru._library()


def _unfused_cell(cell: LayerNormGRUCell, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cell as it ran before the norm was fused into the gates: its
    Linear, its ``nn.LayerNorm`` module, then the plain gate chain."""
    fused = cell.ln(cell.fused(torch.cat([h, x], dim=-1)))
    return K.gru_gates_reference(fused.contiguous(), h.contiguous())


def test_torch_gru_ln_cell_on_the_cpu_runs_the_unfused_ops():
    """On the CPU the cell's output and its gradients are bit-equal to the
    unfused ops'."""
    torch.manual_seed(0)
    cell = LayerNormGRUCell(6, 16, use_bias=False, layer_norm=True)
    with torch.no_grad():
        cell.ln.weight.add_(0.3 * torch.randn(48))
        cell.ln.bias.add_(0.2 * torch.randn(48))
    rng = np.random.default_rng(10)
    h, x = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((5, 16), (5, 6)))
    grads = []
    for fn in (cell, lambda hh, xx: _unfused_cell(cell, hh, xx)):
        cell.zero_grad()
        out = fn(h, x)
        (out ** 2).sum().backward()
        grads.append([out.detach()] + [p.grad.clone() for p in cell.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_torch_gru_ln_rssm_checkpoint_from_before_the_fusion_loads_and_matches():
    """A recurrent model's state dict under the keys the unfused cell wrote
    (``rnn.ln.weight`` and ``rnn.ln.bias`` beside ``rnn.fused.weight``)
    loads strictly into today's model and gives, on the CPU, the unfused
    cell's output bit for bit."""
    in_dim, H, units = 10, 16, 12
    rng = np.random.default_rng(11)
    shapes = {
        "mlp.dense_0.weight": (units, in_dim), "mlp.dense_0.bias": (units,),
        "mlp.ln_0.weight": (units,), "mlp.ln_0.bias": (units,),
        "rnn.fused.weight": (3 * H, H + units), "rnn.ln.weight": (3 * H,), "rnn.ln.bias": (3 * H,),
    }
    saved = {k: torch.from_numpy((rng.normal(size=s) * 0.5 + (1.0 if k.endswith("ln.weight") else 0.0)).astype(np.float32))
             for k, s in shapes.items()}
    buf = io.BytesIO()
    torch.save(saved, buf)
    buf.seek(0)
    model = RecurrentModel(in_dim, H, units)
    assert sorted(model.state_dict()) == sorted(shapes)
    model.load_state_dict(torch.load(buf), strict=True)
    x = torch.from_numpy(rng.normal(size=(7, in_dim)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(7, H)).astype(np.float32))
    with torch.no_grad():
        got = model(x, h)
        mlp = model.mlp(x)
        proj = F.linear(torch.cat([h, mlp], dim=-1), saved["rnn.fused.weight"])
        y = F.layer_norm(proj, (3 * H,), saved["rnn.ln.weight"], saved["rnn.ln.bias"], EPS)
        want = K.gru_gates_reference(y, h)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
