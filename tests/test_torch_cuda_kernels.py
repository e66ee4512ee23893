"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only PyTorch and CUDA, without
the repository's JAX test bootstrap::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.models import LayerNormGRUCell
from sheeprl_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, H, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 3 * H)).astype(np.float32) * 2.0, rng.normal(size=(B, H)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(1, 512), (32, 512), (7, 13), (3, 4096)], ids=["B1", "B32", "scalar-path", "XL-width"]
)
def test_torch_cuda_gru_gates_matches_plain(cuda, shape, dtype):
    """The kernel against the plain version computed in f32 and cast to the
    IO dtype: f32 atol 1e-6 rtol 1e-5, bf16 atol and rtol 1e-2 (one bf16
    rounding)."""
    fused, h = _inputs(*shape)
    dt = getattr(torch, dtype)
    f_t = torch.from_numpy(fused).to(cuda, dt)
    h_t = torch.from_numpy(h).to(cuda, dt)
    before = K.LAUNCHES["gru_gates"]
    got = K.gru_gates(f_t, h_t)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1 and got.dtype == dt and got.shape == h_t.shape
    want = K.gru_gates_reference(f_t.float(), h_t.float()).to(dt)
    f32 = dtype == "float32"
    torch.testing.assert_close(got, want, atol=1e-6 if f32 else 1e-2, rtol=1e-5 if f32 else 1e-2)


def test_torch_cuda_gru_gates_rejects_what_the_kernel_does_not_take(cuda):
    fused, h = (torch.from_numpy(a).to(cuda) for a in _inputs(4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.gru_gates(fused.half(), h.half())
    with pytest.raises(ValueError, match=r"\(B, 3H\)"):
        K.gru_gates(fused[:, :12], h)
    with pytest.raises(ValueError, match="contiguous"):
        K.gru_gates(fused.t().contiguous().t(), h)


def test_torch_cuda_gru_gates_backward_is_the_reference_gradient(cuda):
    fused, h = _inputs(5, 16, seed=2)
    grads = {}
    for dev in ("cpu", "cuda"):
        f_t = torch.from_numpy(fused).to(dev).requires_grad_(True)
        h_t = torch.from_numpy(h).to(dev).requires_grad_(True)
        (K.gru_gates(f_t, h_t) ** 2).sum().backward()
        grads[dev] = (f_t.grad.cpu(), h_t.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_torch_cuda_gru_cell_launches_the_kernel(cuda):
    """The RSSM cell on the card goes through the kernel, once per call, and
    matches the cell on the CPU (TF32 off; atol 1e-5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = LayerNormGRUCell(24, 64, use_bias=False, layer_norm=True)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(8, 24)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    with torch.no_grad():
        want = cell(h, x)
        before = K.LAUNCHES["gru_gates"]
        got = cell.to(cuda)(h.to(cuda), x.to(cuda))
        torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
