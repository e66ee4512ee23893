"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only PyTorch and CUDA, without
the repository's JAX test bootstrap::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import importlib

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


def _ln_inputs(B, H, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.normal(size=(B, 3 * H)) * 2.0 + 0.5).astype(np.float32), rng.normal(size=(B, H)).astype(np.float32),
        (1.0 + 0.3 * rng.normal(size=(3 * H,))).astype(np.float32), (0.2 * rng.normal(size=(3 * H,))).astype(np.float32),
    )


def _misaligned(t):
    """``t``'s values in a contiguous tensor that starts one element past an
    aligned address, so the kernel cannot take 16-byte vectors."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [(1, 512), (8, 512), (16, 512), (32, 512), (1024, 512), (1024, 4096), (7, 13), (3, 2056), (2, 6000),
     (5, 512, "misaligned"), (1, 600), (16, 600), (800, 600), (16, 400), (800, 400)],
    ids=["B1", "B8", "B16", "B32", "imagination", "H4096", "scalar-path", "2-quads-a-thread", "wide-row-path",
         "misaligned", "v2-B1", "v2-B16", "v2-imagination", "v2-explore-B16", "v2-explore-imagination"],
)
def test_torch_cuda_gru_gates_ln_matches_plain(cuda, shape, dtype):
    """The fused LayerNorm + gate kernel against its plain version on the
    same inputs (the bf16 entry: a bf16 projection and carry, the float32
    affine, the normalised projection rounded to bf16 before the gates): f32
    atol and rtol 1e-5 (the row statistics are summed in another order), bf16
    atol and rtol 1e-2 (a normalised projection within float32 rounding of a
    bf16 rounding boundary rounds the other way). One launch per call,
    counted as a ``gru_gates`` launch."""
    B, H = shape[:2]
    dt = getattr(torch, dtype)
    proj, h, w, b = (torch.from_numpy(a).to(cuda) for a in _ln_inputs(B, H, seed=B + H))
    proj, h = proj.to(dt), h.to(dt)  # the affine stays float32, the parameter dtype
    if len(shape) > 2:
        proj, h, w, b = (_misaligned(t) for t in (proj, h, w, b))
    before = K.LAUNCHES["gru_gates"]
    got = K.gru_gates_ln(proj, h, w, b, 1e-3)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1 and got.dtype == dt and got.shape == h.shape
    want = K.gru_gates_ln_reference(proj.cpu(), h.cpu(), w.cpu(), b.cpu(), 1e-3).to(cuda)
    f32 = dtype == "float32"
    torch.testing.assert_close(got, want, atol=1e-5 if f32 else 1e-2, rtol=1e-5 if f32 else 1e-2)


@pytest.mark.parametrize("shape", [(1, 512), (16, 512), (800, 600), (7, 13), (5, 512, "misaligned")],
                         ids=["session", "B16", "v2-imagination", "scalar-path", "misaligned"])
def test_torch_cuda_gru_gates_ln_bf16_projection_over_f32_carry(cuda, shape):
    """A bf16 projection over a float32 carry (a player's or a serving
    session's RSSM state under ``bf16-mixed``): the output is float32, as
    the Pallas kernel writes the carry's dtype, against the plain version on
    the same inputs within atol and rtol 1e-2 (a normalised projection within
    float32 rounding of a bf16 rounding boundary rounds the other way), and
    within 1e-5 on 99 % of the elements (the gate math's float32 rounding)."""
    B, H = shape[:2]
    proj, h, w, b = (torch.from_numpy(a).to(cuda) for a in _ln_inputs(B, H, seed=B + H))
    proj = proj.bfloat16()
    if len(shape) > 2:
        proj, h, w, b = (_misaligned(t) for t in (proj, h, w, b))
    before = K.LAUNCHES["gru_gates"]
    got = K.gru_gates_ln(proj, h, w, b, 1e-3)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1 and got.dtype == torch.float32
    want = K.gru_gates_ln_reference(proj.cpu(), h.cpu(), w.cpu(), b.cpu(), 1e-3).to(cuda)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    assert float(((got - want).abs() <= 1e-5).float().mean()) >= 0.99


def test_torch_cuda_gru_gates_ln_bf16_entry_takes_a_float32_affine(cuda):
    proj, h, w, b = (torch.from_numpy(a).to(cuda) for a in _ln_inputs(4, 8))
    with pytest.raises(TypeError, match="float32 weight"):
        K.gru_gates_ln(proj.bfloat16(), h.bfloat16(), w.bfloat16(), b, 1e-3)
    with pytest.raises(TypeError, match="projection"):
        K.gru_gates_ln(proj, h.bfloat16(), w, b, 1e-3)


def test_torch_cuda_gru_gates_ln_rejects_what_the_kernel_does_not_take(cuda):
    proj, h, w, b = (torch.from_numpy(a).to(cuda) for a in _ln_inputs(4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        K.gru_gates_ln(proj.t().contiguous().t(), h, w, b, 1e-3)
    with pytest.raises(TypeError, match="dtype"):
        K.gru_gates_ln(proj, h, w.double(), b, 1e-3)
    with pytest.raises(ValueError, match=r"\(24,\) bias"):
        K.gru_gates_ln(proj, h, w, b[:12], 1e-3)
    with pytest.raises(ValueError, match="CUDA device"):
        K.gru_gates_ln(proj, h, w.cpu(), b, 1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.gru_gates_ln(proj.half(), h.half(), w.half(), b.half(), 1e-3)


def test_torch_cuda_gru_gates_ln_backward_is_the_plain_gradient(cuda):
    """Gradients for the projection, the carry and the affine through the
    kernel's autograd.Function against the plain chain's on the CPU: atol
    and rtol 1e-5."""
    arrays = _ln_inputs(5, 16, seed=2)
    cot = np.random.default_rng(3).normal(size=(5, 16)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        K.gru_gates_ln(*leaves, 1e-3).backward(torch.from_numpy(cot).to(dev))
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _two_hot_inputs(n, k, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)).astype(np.float32) * scale
    logits = x - np.log(np.exp(x).sum(-1, keepdims=True))
    value = (rng.normal(size=(n, 1)) * 30).astype(np.float32)
    value[:4, 0] = [0.0, -1.0, 1e10, -1e10]  # zero, negative, beyond +-20 in symlog space
    return logits.astype(np.float32), value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024, 255), (37, 17), (3, 4, 255)], ids=["reward-head", "odd-K", "batched"])
def test_torch_cuda_two_hot_kernels_match_plain(cuda, shape, dtype):
    """Both kernels against the plain versions computed in f32 on the same
    (rounded) inputs: f32 within atol 1e-4 rtol 1e-5 (the in-kernel bins
    ``low + i * step`` and ``torch.linspace`` differ by an ulp of 20, which
    moves a two-hot weight by ~1e-5 against logits of ~-15), bf16 within one
    bf16 rounding of the output (rtol 1e-2, atol 2e-2)."""
    n, k = int(np.prod(shape[:-1])), shape[-1]
    logits, value = _two_hot_inputs(n, k)
    dt = getattr(torch, dtype)
    lg = torch.from_numpy(logits).reshape(shape).to(cuda, dt)
    v = torch.from_numpy(value).reshape(*shape[:-1], 1).to(cuda)
    before = dict(K.LAUNCHES)
    loss, mean = K.two_hot_symlog_loss(lg, v), K.two_hot_symexp_decode(lg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["two_hot_symlog_loss"] == before["two_hot_symlog_loss"] + 1
    assert K.LAUNCHES["two_hot_symexp_decode"] == before["two_hot_symexp_decode"] + 1
    assert loss.shape == shape[:-1] and mean.shape == (*shape[:-1], 1) and loss.dtype == mean.dtype == dt
    f32 = dtype == "float32"
    tol = dict(atol=1e-4, rtol=1e-5) if f32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(loss.float(), K.two_hot_symlog_loss_reference(lg.float(), v), **tol)
    torch.testing.assert_close(mean.float(), K.two_hot_symexp_decode_reference(lg.float()), **tol)


@pytest.mark.parametrize("k", [1, 17, 255])
def test_torch_cuda_two_hot_loss_brackets_on_and_between_bins(cuda, k):
    """The loss kernel finds its bracket in closed form: targets on every bin,
    halfway between neighbours, beyond the support and NaN give what the
    plain version's count over all K bins gives (f32, atol 1e-4 rtol 1e-5;
    NaN where it gives NaN)."""
    bins = np.linspace(-20.0, 20.0, k)
    mids = (bins[1:] + bins[:-1]) / 2
    x = np.concatenate([bins, mids, [-25.0, 25.0, np.inf, -np.inf, np.nan]])
    value = torch.from_numpy((np.sign(x) * np.expm1(np.abs(x))).astype(np.float32)[:, None]).to(cuda)
    logits = torch.from_numpy(_two_hot_inputs(len(x), k, seed=7)[0]).to(cuda)
    got = K.two_hot_symlog_loss(logits, value)
    torch.testing.assert_close(got, K.two_hot_symlog_loss_reference(logits, value), atol=1e-4, rtol=1e-5,
                               equal_nan=True)


def test_torch_cuda_two_hot_kernels_reject_what_they_do_not_take(cuda):
    logits, value = (torch.from_numpy(a).to(cuda) for a in _two_hot_inputs(8, 17))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.two_hot_symexp_decode(logits.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.two_hot_symlog_loss(logits.double(), value)
    with pytest.raises(ValueError, match="contiguous"):
        K.two_hot_symexp_decode(logits.t().contiguous().t())
    with pytest.raises(ValueError, match="broadcast"):
        K.two_hot_symlog_loss(logits, value[:3])
    with pytest.raises(ValueError, match=str(value.device).split(":")[0]):
        K.two_hot_symlog_loss(logits, value.cpu())
    with pytest.raises(ValueError, match="at most 512"):
        K.two_hot_symexp_decode(torch.zeros((2, 513), device=cuda))
    with pytest.raises(RuntimeError, match="cudaError"):  # the bins must rise
        K.two_hot_symlog_loss(logits, value, low=20.0, high=-20.0)


def test_torch_cuda_two_hot_backward_is_the_plain_gradient(cuda):
    """Each autograd.Function's gradient on the card against the plain
    chain's on the CPU, under a fixed weighting of the outputs (the
    decode's logits spread as a head's do, so its values stay moderate)."""
    logits, value = _two_hot_inputs(16, 255, seed=4, scale=1.0)
    value[4:, 0] = np.random.default_rng(5).normal(size=12) * 4  # inside the support
    grads = {}
    for dev in ("cpu", "cuda"):
        lg = torch.from_numpy(logits).to(dev).requires_grad_(True)
        v = torch.from_numpy(value).to(dev).requires_grad_(True)
        weight = torch.linspace(0.5, 2.0, 16, device=dev)
        (K.two_hot_symlog_loss(lg, v) * weight).sum().backward()
        g_loss = (lg.grad.cpu(), v.grad.cpu())
        lg.grad = None
        (K.two_hot_symexp_decode(lg)[:, 0] * weight).sum().backward()
        grads[dev] = (*g_loss, lg.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_torch_cuda_two_hot_distribution_goes_through_the_kernels(cuda):
    """The distribution on raw logits: ``mean`` one decode launch,
    ``log_prob`` one fused-loss launch and its backward one backward launch,
    none of the unfused ``two_hot_symlog_loss``; values as on the CPU within
    atol 1e-4 rtol 1e-5, the logits' gradient within atol 1e-6 rtol 1e-5."""
    from sheeprl_tpu_torch.distributions import TwoHotEncodingDistribution

    logits, value = _two_hot_inputs(6, 255, seed=6)
    logits = logits * 2 + 1.5  # raw head outputs, not normalised
    leaf = torch.from_numpy(logits).to(cuda).requires_grad_(True)
    dist = TwoHotEncodingDistribution(leaf)
    before = dict(K.LAUNCHES)
    mean, logp = dist.mean, dist.log_prob(torch.from_numpy(value).to(cuda))
    logp.sum().backward()
    torch.cuda.synchronize()
    launched = {name: K.LAUNCHES[name] - before[name] for name in K.LAUNCHES}
    assert launched == dict({name: 0 for name in K.LAUNCHES}, two_hot_symexp_decode=1, two_hot_symlog_loss_lse=1,
                            two_hot_symlog_loss_lse_bwd=1)
    cpu_leaf = torch.from_numpy(logits).requires_grad_(True)
    cpu = TwoHotEncodingDistribution(cpu_leaf)
    cpu.log_prob(torch.from_numpy(value)).sum().backward()
    torch.testing.assert_close(mean.detach().cpu(), cpu.mean.detach(), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(logp.detach().cpu(), cpu.log_prob(torch.from_numpy(value)).detach(), atol=1e-4,
                               rtol=1e-5)
    torch.testing.assert_close(leaf.grad.cpu(), cpu_leaf.grad, atol=1e-6, rtol=1e-5)


def _lse_inputs(cuda, n, k, dtype, misaligned=False, seed=0):
    """Raw logits, targets with the special ones first (zero, negatives,
    beyond +-20 in symlog space, NaN-free), then one on each bin as far as n
    allows, and an upstream gradient in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, k)).astype(np.float32) * 3 + 1.5
    value = (rng.normal(size=(n, 1)) * 30).astype(np.float32)
    bins = np.linspace(-20.0, 20.0, k, dtype=np.float32)
    special = np.concatenate([[0.0, -1.0, -250.0, 3.5, 1e10, -1e10, np.expm1(20.0)],
                              np.sign(bins) * np.expm1(np.abs(bins))]).astype(np.float32)[:n]
    value[: len(special), 0] = special
    grad = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    dt = getattr(torch, dtype)
    lg = torch.from_numpy(logits).to(cuda, dt)
    if misaligned:
        lg = _misaligned(lg)
    return lg, torch.from_numpy(value).to(cuda), torch.from_numpy(grad).to(cuda, dt)


LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=1e-2)}
# a row's softmax terms are ~1e-4 each, so the f32 gradient's atol sits well below them
LSE_GRAD_TOL = {"float32": dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 1024, 15360])
def test_torch_cuda_two_hot_lse_kernels_match_plain(cuda, n, dtype, misaligned):
    """The fused loss over raw logits and its backward kernel against their
    plain versions computed in f32 on the same (rounded) inputs: f32 atol
    1e-4 rtol 1e-5 (the kernels' bins are ``torch.linspace``'s floats, so
    targets bracket alike, on a bin too, and what differs is the order of
    the sums and the exps' rounding), bf16 atol 2e-2 rtol 1e-2 (one bf16
    rounding); the rows' lse within 1e-5; the f32 gradient within atol 1e-6
    rtol 1e-5. One launch each."""
    lg, v, g = _lse_inputs(cuda, n, 255, dtype, misaligned, seed=n)
    twohot = importlib.import_module("sheeprl_tpu_torch.ops.kernels.twohot")
    before = dict(K.LAUNCHES)
    out, lse = twohot._launch_loss_lse(lg, v, -20.0, 20.0)
    dx = twohot._launch_loss_lse_bwd(lg, v, lse, g, -20.0, 20.0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["two_hot_symlog_loss_lse"] == before["two_hot_symlog_loss_lse"] + 1
    assert K.LAUNCHES["two_hot_symlog_loss_lse_bwd"] == before["two_hot_symlog_loss_lse_bwd"] + 1
    assert out.dtype == dx.dtype == lg.dtype and lse.dtype == torch.float32 and dx.shape == lg.shape
    torch.testing.assert_close(out.float(), K.two_hot_symlog_loss_lse_reference(lg.float(), v), **LSE_TOL[dtype])
    torch.testing.assert_close(lse, torch.logsumexp(lg.float(), dim=-1), atol=1e-5, rtol=1e-5)
    want = K.two_hot_symlog_loss_lse_grad_reference(lg.float(), v, lse, g.float())
    torch.testing.assert_close(dx.float(), want, **LSE_GRAD_TOL[dtype])


# row counts that take 8, 16 and 32 lanes a row (15360, 5000, 37), odd K,
# rows past 256 bins (16 or 32 lanes) up to the 512 the kernels hold
LSE_ROW_LENGTHS = [(15360, 255), (5000, 255), (37, 255), (300, 17), (70, 1), (40, 256), (9000, 400), (90, 400),
                   (40, 512)]


@pytest.mark.parametrize("shape", LSE_ROW_LENGTHS, ids=[f"{n}x{k}" for n, k in LSE_ROW_LENGTHS])
def test_torch_cuda_two_hot_lse_every_row_length_matches_plain(cuda, shape):
    """The fused loss and its backward at every lane count the launch picks
    and at both register layouts, each to its last bin: f32 against the
    plain versions as above."""
    n, k = shape
    lg, v, g = _lse_inputs(cuda, n, k, "float32", seed=n + k)
    twohot = importlib.import_module("sheeprl_tpu_torch.ops.kernels.twohot")
    out, lse = twohot._launch_loss_lse(lg, v, -20.0, 20.0)
    dx = twohot._launch_loss_lse_bwd(lg, v, lse, g, -20.0, 20.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, K.two_hot_symlog_loss_lse_reference(lg, v), **LSE_TOL["float32"])
    torch.testing.assert_close(lse, torch.logsumexp(lg, dim=-1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx, K.two_hot_symlog_loss_lse_grad_reference(lg, v, lse, g), **LSE_GRAD_TOL["float32"])


def test_torch_cuda_two_hot_lse_rejects_what_the_kernels_do_not_take(cuda):
    twohot = importlib.import_module("sheeprl_tpu_torch.ops.kernels.twohot")
    lg, v, g = _lse_inputs(cuda, 8, 17, "float32")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.two_hot_symlog_loss_lse(lg.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        K.two_hot_symlog_loss_lse(lg.t().contiguous().t(), v)
    with pytest.raises(ValueError, match="broadcast"):
        K.two_hot_symlog_loss_lse(lg, v[:3])
    with pytest.raises(ValueError, match="at most 512"):
        K.two_hot_symlog_loss_lse(torch.zeros((2, 513), device=cuda), v[:2])
    _, lse = twohot._launch_loss_lse(lg, v, -20.0, 20.0)
    with pytest.raises(ValueError, match="float32 lse"):
        twohot._launch_loss_lse_bwd(lg, v, lse[:4], g, -20.0, 20.0)
    with pytest.raises(ValueError, match="gradient"):
        twohot._launch_loss_lse_bwd(lg, v, lse, g[:4], -20.0, 20.0)
    with pytest.raises(RuntimeError, match="cudaError"):  # the bins must rise
        K.two_hot_symlog_loss_lse(lg, v, low=20.0, high=-20.0)


def test_torch_cuda_two_hot_lse_backward_is_the_plain_gradient(cuda):
    """Gradients for the raw logits and the value through the Function on
    the card (the backward kernel; the value's through the plain chain)
    against autograd of the plain chain on the CPU: the logits' within atol
    1e-6 rtol 1e-5, the value's within atol and rtol 1e-5."""
    lg, v, g = _lse_inputs(cuda, 16, 255, "float32", seed=4)
    v[8:, 0] = torch.linspace(-40.0, 40.0, 8, device=cuda)  # inside the support, where d/dvalue != 0
    grads = {}
    for dev in ("cpu", "cuda"):
        leaf, val = lg.to(dev).requires_grad_(True), v.to(dev).requires_grad_(True)
        K.two_hot_symlog_loss_lse(leaf, val).backward(g.to(dev))
        grads[dev] = (leaf.grad.cpu(), val.grad.cpu())
    torch.testing.assert_close(grads["cuda"][0], grads["cpu"][0], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(grads["cuda"][1], grads["cpu"][1], atol=1e-5, rtol=1e-5)


def _gae_inputs(T, N, trailing=(1,), seed=0):
    rng = np.random.default_rng(seed)
    shape = (T, N) + trailing
    dones = rng.uniform(size=shape) < 0.05
    if T > 2:
        dones[T // 2, ::2] = True  # terminal flags in the middle of columns
    return (rng.normal(size=shape).astype(np.float32), (rng.normal(size=shape) * 3).astype(np.float32), dones,
            rng.normal(size=shape[1:]).astype(np.float32))


@pytest.mark.parametrize("done_dtype", ["uint8", "bool", "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize(
    "shape", [(128, 4, 1), (128, 4), (1, 7), (128, 1000), (1024, 4096), (512, 16, 1), (5, 4, 1)],
    ids=["main-path", "no-trailing-axis", "T1", "ragged-N", "bandwidth", "recurrent-ppo", "a2c"],
)
def test_torch_cuda_gae_matches_plain(cuda, shape, dtype, done_dtype):
    """The kernel against the plain version on the same (rounded) inputs,
    float32 math on both sides in the same op order: within atol and rtol
    1e-6 for every input dtype, one launch per call, float32 outputs."""
    r, v, d, nv = _gae_inputs(shape[0], shape[1], shape[2:])
    dt = getattr(torch, dtype)
    args = (
        torch.from_numpy(r).to(cuda, dt), torch.from_numpy(v).to(cuda, dt),
        torch.from_numpy(d).to(cuda, getattr(torch, done_dtype)), torch.from_numpy(nv).to(cuda, dt),
    )
    before = K.LAUNCHES["gae"]
    got = K.gae(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gae"] == before + 1
    want = K.gae_reference(*args, 0.99, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == args[0].shape
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("done_dtype", ["uint8", "bool", "float32"])
@pytest.mark.parametrize("N", [1, 4, 33, 4096])
@pytest.mark.parametrize("T", [1, 200, 300], ids=["T1", "T-ragged-tile", "T-3-tiles"])
def test_torch_cuda_gae_tiles_are_bit_equal_to_plain(cuda, T, N, done_dtype):
    """Every tile layout of the kernel (one span or one span per row, one
    tile, a ragged last tile, three tiles with the value carried across
    their edges) gives advantages and returns bit-equal to the plain
    version's."""
    r, v, d, nv = _gae_inputs(T, N, (), seed=T + N)
    args = (torch.from_numpy(r).to(cuda), torch.from_numpy(v).to(cuda),
            torch.from_numpy(d).to(cuda, getattr(torch, done_dtype)), torch.from_numpy(nv).to(cuda))
    got = K.gae(*args, 0.99, 0.95)
    want = K.gae_reference(*args, 0.99, 0.95)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(131, 4), (131, 37)], ids=["one-span", "span-per-row"])
def test_torch_cuda_gae_misaligned_inputs_are_bit_equal_to_plain(cuda, shape, dtype):
    """Inputs one element past an aligned address: the tiles' 16-byte copies
    cover each span from the aligned address below it."""
    r, v, d, nv = _gae_inputs(*shape, (), seed=5)
    dt = getattr(torch, dtype)
    args = [_misaligned(torch.from_numpy(a).to(cuda, t)) for a, t in ((r, dt), (v, dt), (d, torch.uint8), (nv, dt))]
    got = K.gae(*args, 0.99, 0.95)
    want = K.gae_reference(*args, 0.99, 0.95)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_torch_cuda_gae_rejects_what_the_kernel_does_not_take(cuda):
    r, v, d, nv = (torch.from_numpy(a).to(cuda) for a in _gae_inputs(8, 4))
    d = d.to(torch.uint8)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        K.gae(r.double(), v, d, nv, 0.99, 0.95)
    with pytest.raises(TypeError, match="uint8, bool or float32 dones"):
        K.gae(r, v, d.to(torch.int32), nv, 0.99, 0.95)
    with pytest.raises(ValueError, match="contiguous"):
        K.gae(r[::2], v[::2], d[::2], nv, 0.99, 0.95)
    with pytest.raises(ValueError, match="next_value"):
        K.gae(r, v, d, nv[:2], 0.99, 0.95)
    with pytest.raises(ValueError, match="CUDA device"):
        K.gae(r, v, d.cpu(), nv, 0.99, 0.95)


def test_torch_cuda_gae_backward_is_the_plain_gradient(cuda):
    r, v, d, nv = _gae_inputs(32, 5, seed=3)
    rng = np.random.default_rng(4)
    w = [torch.from_numpy(rng.uniform(0.5, 2.0, size=r.shape).astype(np.float32)) for _ in range(2)]
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in (r, v, nv)]
        ret, adv = K.gae(leaves[0], leaves[1], torch.from_numpy(d).to(dev), leaves[2], 0.99, 0.95)
        ((ret * w[0].to(dev)).sum() + (adv * w[1].to(dev)).sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _factor_args(cuda, T, P, N, trailing=(1,), seed=0, done_dtype="float32"):
    r, v, d, nv = _gae_inputs(T, P * N, (), seed=seed)
    shape = (T, P, N) + trailing
    rng = np.random.default_rng(seed + 1)
    gamma = rng.uniform(0.9, 0.999, size=P).astype(np.float32)
    lam = rng.uniform(0.5, 0.99, size=P).astype(np.float32)
    tensors = [torch.from_numpy(a.reshape(s)).to(cuda) for a, s in ((r, shape), (v, shape), (nv, shape[1:]))]
    dones = torch.from_numpy(d.reshape(shape)).to(cuda, getattr(torch, done_dtype))
    return (tensors[0], tensors[1], dones, tensors[2], torch.from_numpy(gamma).to(cuda), torch.from_numpy(lam).to(cuda))


@pytest.mark.parametrize("done_dtype", ["uint8", "bool", "float32"])
@pytest.mark.parametrize("T, P, N, trailing", [(128, 8, 4, (1,)), (128, 4, 4, (1,)), (16, 2, 3, ()), (300, 5, 33, ()),
                                               (1, 3, 4, (1,))],
                         ids=["population-main-path", "pbt-main-path", "small", "tiles-and-rows", "T1"])
def test_torch_cuda_gae_factors_are_bit_equal_to_plain(cuda, T, P, N, trailing, done_dtype):
    """The per-member entry (``gae_launch_factors``): each column's own
    gamma and gamma * lambda, bit-equal to the plain version, one launch."""
    args = _factor_args(cuda, T, P, N, trailing, seed=T + P, done_dtype=done_dtype)
    before = K.LAUNCHES["gae"]
    got = K.gae_factors(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gae"] == before + 1
    want = K.gae_factors_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == args[0].shape
        assert torch.equal(g, w)


def test_torch_cuda_gae_factors_of_equal_members_are_the_scalar_entry(cuda):
    r, v, d, nv, _, _ = _factor_args(cuda, 128, 4, 4)
    got = K.gae_factors(r, v, d, nv, torch.full((4,), 0.99, device=cuda), torch.full((4,), 0.95, device=cuda))
    for m in range(4):
        want = K.gae(r[:, m].contiguous(), v[:, m].contiguous(), d[:, m].contiguous(), nv[m].contiguous(), 0.99, 0.95)
        assert torch.equal(got[0][:, m], want[0]) and torch.equal(got[1][:, m], want[1])


def test_torch_cuda_gae_factors_rejects_what_the_kernel_does_not_take(cuda):
    r, v, d, nv, g, lam = _factor_args(cuda, 8, 2, 3)
    with pytest.raises(ValueError, match="gae_factors wants"):
        K.gae_factors(r, v, d, nv, g[:1], lam[:1])
    with pytest.raises(ValueError, match="gae_factors kernel wants"):
        K.gae_factors(r, v, d, nv, g.cpu(), lam)


def test_torch_cuda_anakin_runs_launch_gae_once_per_iteration(cuda, tmp_path):
    """Three single-run Anakin iterations and two of a 3-member population on
    the card: ``gae`` once per iteration (the population's per-member entry
    included), no other kernel."""
    from sheeprl_tpu_torch import cli

    small = ["metric.log_level=0", "algo.run_test=false", "algo.update_epochs=1", f"log_root={tmp_path}"]
    K.reset_launches()
    summary = cli.run(["preset=ppo_anakin", "algo.total_steps=1536", *small])
    assert summary["device"].startswith("cuda") and summary["iterations"] == 3
    assert K.LAUNCHES == dict({name: 0 for name in K.LAUNCHES}, gae=3)
    K.reset_launches()
    summary = cli.run(["preset=ppo_anakin_population", "algo.population.size=3", "algo.population.hparams={}",
                       "algo.total_steps=1024", *small])
    assert summary["iterations"] == 2 and K.LAUNCHES == dict({name: 0 for name in K.LAUNCHES}, gae=2)


def test_torch_cuda_ppo_rollout_gae_launches_once_per_iteration(cuda, tmp_path):
    """Two iterations of the PPO loop on the card: ``gae`` launched twice,
    no other kernel."""
    from sheeprl_tpu_torch import cli

    K.reset_launches()
    summary = cli.run(["preset=ppo", "metric.log_level=0", "algo.run_test=false", "algo.total_steps=1024",
                       "algo.update_epochs=1", f"log_root={tmp_path}"])
    assert summary["device"].startswith("cuda") and summary["iterations"] == 2
    assert K.LAUNCHES == dict({name: 0 for name in K.LAUNCHES}, gae=2)


@pytest.mark.parametrize("args, iterations", [
    (["preset=a2c", "algo.total_steps=200"], 10),
    (["preset=ppo_recurrent", "env.num_envs=4", "algo.rollout_steps=64", "algo.total_steps=512"], 2),
    (["preset=ppo", "env.id=Pendulum-v1", "algo.total_steps=1024", "algo.update_epochs=1"], 2),
], ids=["a2c", "ppo-recurrent", "ppo-continuous"])
def test_torch_cuda_ppo_family_gae_launches_once_per_iteration(cuda, tmp_path, args, iterations):
    """A short run of each PPO-family path on the card: ``gae`` launched
    once per iteration, no other kernel; the losses finite."""
    from sheeprl_tpu_torch import cli

    K.reset_launches()
    summary = cli.run(args + ["metric.log_level=0", "algo.run_test=false", f"log_root={tmp_path}"])
    assert summary["device"].startswith("cuda") and summary["iterations"] == iterations
    assert K.LAUNCHES == dict({name: 0 for name in K.LAUNCHES}, gae=iterations)
    assert np.isfinite(np.asarray(summary["losses"])).all()


def _sumtree_inputs(leaves, batch, seed=0):
    """A ``(2P,)`` tree with ``leaves`` filled leaves (every fifth zero, the
    rest of the power-of-two padding zero) and ``batch`` uniforms, 0 and
    values just under 1 among them."""
    from sheeprl_tpu_torch.replay import sumtree as st

    rng = np.random.default_rng(seed)
    prios = rng.uniform(0.01, 2.0, size=leaves).astype(np.float32)
    prios[::5] = 0.0
    tree = st.update(st.init(leaves), torch.arange(leaves), torch.from_numpy(prios))
    u = rng.uniform(size=batch).astype(np.float32)
    u[: min(batch, 3)] = np.array([0.0, np.nextafter(np.float32(1), np.float32(0)), 1 - 1e-7], np.float32)[: min(batch, 3)]
    return tree, torch.from_numpy(u), prios


@pytest.mark.parametrize("batch", [1, 256, 4096])
@pytest.mark.parametrize("leaves", [2, 5, 40, 1000, 60_000, 1_000_000],
                         ids=["P2", "P8-shallower-than-k", "P64", "P1024", "P65536", "sac-path"])
def test_torch_cuda_sumtree_sample_matches_plain(cuda, leaves, batch):
    """The kernel against the plain version on the same tree and uniforms:
    leaves equal, weights within rtol 1e-6 (``powf`` against ``torch.pow``),
    no zero-priority leaf drawn, one launch per call; trees of fewer levels
    than the kernel settles per hop included."""
    tree, u, prios = _sumtree_inputs(leaves, batch, seed=leaves + batch)
    tree, u = tree.to(cuda), u.to(cuda)
    before = K.LAUNCHES["sumtree_sample"]
    leaf, w = K.sumtree_sample(tree, u, leaves, 0.55)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sumtree_sample"] == before + 1 and leaf.dtype == torch.int32 and w.dtype == torch.float32
    want_leaf, want_w = K.sumtree_sample_reference(tree, u, leaves, 0.55)
    assert torch.equal(leaf, want_leaf)
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)
    assert (prios[leaf.cpu().numpy()] > 0).all()


@pytest.mark.parametrize("hop_levels", range(1, 11))
def test_torch_cuda_sumtree_sample_every_hop_width_matches_plain(cuda, hop_levels):
    """Every width the kernel takes (k levels per dependent read), on deep
    trees, on one shallower than k and on a one-leaf tree (no level to
    walk): the plain version's leaves, weights within rtol 1e-6."""
    from sheeprl_tpu_torch.replay import sumtree as st

    sumtree_module = importlib.import_module("sheeprl_tpu_torch.ops.kernels.sumtree")
    one_leaf = (st.update(st.init(1), torch.zeros(1, dtype=torch.long), torch.tensor([1.5])), torch.rand(7))
    for leaves in (1, 5, 1000, 60_000):
        tree, u, _ = one_leaf + (None,) if leaves == 1 else _sumtree_inputs(leaves, 300, seed=hop_levels)
        tree, u = tree.to(cuda), u.to(cuda)
        leaf, w = sumtree_module._launch(tree, u, leaves, 0.55, hop_levels=hop_levels)
        torch.cuda.synchronize()
        want_leaf, want_w = K.sumtree_sample_reference(tree, u, leaves, 0.55)
        assert torch.equal(leaf, want_leaf), leaves
        torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)


def test_torch_cuda_sumtree_sample_rejects_what_the_kernel_does_not_take(cuda):
    tree, u, _ = _sumtree_inputs(100, 8)
    tree, u = tree.to(cuda), u.to(cuda)
    with pytest.raises(TypeError, match="float32"):
        K.sumtree_sample(tree.double(), u, 100, 0.4)
    with pytest.raises(ValueError, match="power of two"):
        K.sumtree_sample(tree[:200], u, 100, 0.4)
    with pytest.raises(ValueError, match="contiguous"):
        K.sumtree_sample(tree, torch.rand(16, device=cuda)[::2], 100, 0.4)
    with pytest.raises(ValueError, match="CUDA device"):
        K.sumtree_sample(tree, u.cpu(), 100, 0.4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.sumtree_sample(torch.zeros(257, device=cuda)[1:], u, 100, 0.4)


def test_torch_cuda_sumtree_sample_backward_is_the_plain_gradient(cuda):
    tree, u, _ = _sumtree_inputs(300, 64, seed=5)
    scale = torch.rand(64)
    grads = {}
    for dev in ("cpu", "cuda"):
        t = tree.to(dev).clone().requires_grad_(True)
        (K.sumtree_sample(t, u.to(dev), 300, 0.4)[1] * scale.to(dev)).sum().backward()
        grads[dev] = t.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], atol=1e-5, rtol=1e-5)


def test_torch_cuda_sac_per_loop_launches_sumtree_once_per_gradient_step(cuda, tmp_path):
    """A short ``run preset=sac_per`` on the card: ``sumtree_sample`` launched
    exactly once per gradient step, no other kernel."""
    from sheeprl_tpu_torch import cli

    K.reset_launches()
    summary = cli.run(["preset=sac_per", "metric.log_level=0", "algo.run_test=false", "algo.total_steps=400",
                       "buffer.size=4096", "checkpoint.save_last=false", f"log_root={tmp_path}"])
    assert summary["device"].startswith("cuda") and summary["resident"] and summary["gradient_steps"] > 0
    assert K.LAUNCHES == dict({name: 0 for name in K.LAUNCHES}, sumtree_sample=summary["gradient_steps"])


def _scatter_inputs(cuda, dtype, feat, S, e, col_offset, misalign, seed=0):
    """A ring of 13 rows and ``e + col_offset`` env columns, staged rows cut
    from a byte buffer at ``misalign`` bytes (an unpacked upload's segments
    are only 4-byte aligned), a second staged row dropping every other env
    (a ragged reset row), heads wrapping past the capacity."""
    from sheeprl_tpu_torch.data.ring import ring_append_rows

    rng = np.random.default_rng(seed)
    C = 13
    if dtype == torch.uint8:
        storage = torch.from_numpy(rng.integers(0, 256, (C, e + col_offset) + feat).astype(np.uint8))
        fresh = torch.from_numpy(rng.integers(0, 256, (S, e) + feat).astype(np.uint8))
    else:
        storage = torch.from_numpy(rng.normal(size=(C, e + col_offset) + feat).astype(np.float32))
        fresh = torch.from_numpy(rng.normal(size=(S, e) + feat).astype(np.float32))
    n = fresh.numel() * fresh.element_size()
    buf = torch.zeros(n + 16, dtype=torch.uint8)
    buf[misalign:misalign + n] = fresh.reshape(-1).view(torch.uint8)
    mask = torch.ones((S, e), dtype=torch.int32)
    if S > 1:
        mask[S - 1, ::2] = 0
    pos = torch.full((e,), C - 1, dtype=torch.int32)
    row, _, _ = ring_append_rows(pos, torch.full((e,), C, dtype=torch.int32), mask, C)
    staged = buf.to(cuda)[misalign:misalign + n].view(dtype).reshape(fresh.shape)
    return storage.to(cuda), staged, row.to(cuda), pos.to(cuda)


@pytest.mark.parametrize(
    "dtype, misalign",
    [(torch.uint8, 0), (torch.uint8, 4), (torch.uint8, 1), (torch.float32, 0), (torch.float32, 4)],
    ids=["u8-aligned16", "u8-aligned4", "u8-aligned1", "f32-aligned16", "f32-aligned4"],
)
@pytest.mark.parametrize("shape", [(1, 1, (1,)), (2, 4, (18,)), (2, 1, (64, 64, 3)), (1, 4, (64, 64, 3))],
                         ids=["scalar", "actions", "frames", "frames-4envs"])
@pytest.mark.parametrize("col_offset", [0, 2])
def test_torch_cuda_ragged_ring_scatter_matches_plain(cuda, dtype, shape, misalign, col_offset):
    """The kernel against the plain version on copies of one ring: bit-equal,
    in place, one launch. (A float32 view needs 4-byte alignment, so float32
    rows are cut at 16- and 4-byte offsets only.)"""
    S, e, feat = shape
    storage, staged, row, pos = _scatter_inputs(cuda, dtype, feat, S, e, col_offset, misalign)
    got, want = storage.clone(), storage.clone()
    before = K.LAUNCHES["ragged_ring_scatter"]
    out = K.ragged_ring_scatter(got, staged, row, pos, col_offset)
    torch.cuda.synchronize()
    assert out.data_ptr() == got.data_ptr() and K.LAUNCHES["ragged_ring_scatter"] == before + 1
    K.ragged_ring_scatter_reference(want, staged, row, pos, col_offset)
    assert torch.equal(got, want) and not torch.equal(got, storage)


def test_torch_cuda_ragged_ring_scatter_rejects_what_the_kernel_does_not_take(cuda):
    storage, staged, row, pos = _scatter_inputs(cuda, torch.float32, (3,), 2, 4, 0, 0)
    with pytest.raises(TypeError, match="staged is"):
        K.ragged_ring_scatter(storage, staged.double(), row, pos)
    with pytest.raises(TypeError, match="int32 rows"):
        K.ragged_ring_scatter(storage, staged, row.long(), pos)
    with pytest.raises(ValueError, match="outside the ring"):
        K.ragged_ring_scatter(storage, staged, row, pos, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.ragged_ring_scatter(storage, staged.transpose(0, 1).contiguous().transpose(0, 1), row, pos)
    with pytest.raises(ValueError, match="CUDA device"):
        K.ragged_ring_scatter(storage, staged, row.cpu(), pos)
    with pytest.raises(ValueError, match="slots"):
        K.ragged_ring_scatter(storage, staged[..., :2].contiguous(), row, pos)


def test_torch_cuda_ragged_ring_scatter_backward_is_the_plain_gradient(cuda):
    storage, staged, row, pos = _scatter_inputs(cuda, torch.float32, (3,), 2, 4, 1, 0, seed=4)
    scale = torch.rand(storage.shape)
    grads = {}
    for dev in ("cpu", "cuda"):
        s = storage.to(dev).clone().requires_grad_(True)
        t = staged.to(dev).clone().requires_grad_(True)
        (K.ragged_ring_scatter(s.clone(), t, row.to(dev), pos.to(dev), 1) * scale.to(dev)).sum().backward()
        grads[dev] = (s.grad.cpu(), t.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert torch.equal(a, b)


# the DreamerV3 ring's keys: a 64x64x3 uint8 frame, 18 f32 actions, 3 f32 scalars
RING_KEYS = {"rgb": ((64, 64, 3), torch.uint8), "actions": ((18,), torch.float32),
             "rewards": ((1,), torch.float32), "terminated": ((1,), torch.float32), "is_first": ((1,), torch.float32)}


def _keys_inputs(cuda, names, S, e, col_offset, misalign, seed=0):
    """``_scatter_inputs`` for several keys sharing one row table: each
    key's staged rows cut from a byte buffer at ``misalign`` bytes (float32
    keys at 4 where ``misalign`` is not a multiple of 4)."""
    rings, staged = {}, {}
    for i, k in enumerate(names):
        feat, dtype = RING_KEYS[k]
        cut = misalign if dtype == torch.uint8 or misalign % 4 == 0 else 4
        rings[k], staged[k], row, pos = _scatter_inputs(cuda, dtype, feat, S, e, col_offset, cut, seed=seed + i)
    return rings, staged, row, pos


@pytest.mark.parametrize("misalign", [0, 4, 1], ids=["aligned16", "aligned4", "aligned1"])
@pytest.mark.parametrize("names", [["rgb"], ["actions", "rgb"], list(RING_KEYS)], ids=["1key", "2keys", "5keys"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["1row-1env", "2rows-4envs-dropped"])
@pytest.mark.parametrize("col_offset", [0, 3])
def test_torch_cuda_ragged_ring_scatter_keys_matches_plain(cuda, names, shape, misalign, col_offset):
    """Every key in one launch against the per-key plain version on copies
    of the rings: bit-equal, in place, untouched slots unchanged."""
    S, e = shape
    rings, staged, row, pos = _keys_inputs(cuda, names, S, e, col_offset, misalign)
    got = {k: v.clone() for k, v in rings.items()}
    before = K.LAUNCHES["ragged_ring_scatter"]
    out = K.ragged_ring_scatter_keys(got, staged, row, pos, col_offset)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ragged_ring_scatter"] == before + 1
    for k in names:
        assert out[k].data_ptr() == got[k].data_ptr()
        want = K.ragged_ring_scatter_reference(rings[k].clone(), staged[k], row, pos, col_offset)
        assert torch.equal(got[k], want) and not torch.equal(got[k], rings[k]), k


def test_torch_cuda_ragged_ring_scatter_keys_backward_is_the_plain_gradient(cuda):
    rings, staged, row, pos = _keys_inputs(cuda, list(RING_KEYS), 2, 4, 1, 0, seed=6)
    floats = [k for k, (_, dtype) in RING_KEYS.items() if dtype == torch.float32]
    scale = {k: torch.rand(rings[k].shape) for k in floats}
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = {k: (rings[k].to(dev).clone().requires_grad_(k in floats),
                      staged[k].to(dev).clone().requires_grad_(k in floats)) for k in RING_KEYS}
        out = K.ragged_ring_scatter_keys({k: s.clone() for k, (s, _) in leaves.items()},
                                         {k: t for k, (_, t) in leaves.items()}, row.to(dev), pos.to(dev), 1)
        sum((out[k] * scale[k].to(dev)).sum() for k in floats).backward()
        grads[dev] = {k: (leaves[k][0].grad.cpu(), leaves[k][1].grad.cpu()) for k in floats}
    for k in floats:
        for a, b in zip(grads["cuda"][k], grads["cpu"][k]):
            assert torch.equal(a, b), k


def test_torch_cuda_ragged_ring_scatter_keys_rejects_what_the_kernel_does_not_take(cuda):
    rings, staged, row, pos = _keys_inputs(cuda, list(RING_KEYS), 2, 4, 0, 0)
    with pytest.raises(ValueError, match="capacity"):
        K.ragged_ring_scatter_keys(dict(rings, rewards=rings["rewards"][:5].contiguous()), staged, row, pos)
    with pytest.raises(TypeError, match="staged is"):
        K.ragged_ring_scatter_keys(rings, dict(staged, actions=staged["actions"].double()), row, pos)
    with pytest.raises(ValueError, match="CUDA device"):
        K.ragged_ring_scatter_keys(rings, dict(staged, rewards=staged["rewards"].cpu()), row, pos)


def test_torch_cuda_resident_loop_launches_the_scatter_once_per_flush(cuda, tmp_path):
    """A short ``run preset=dreamer_v3_100k_atari_dummy_resident`` on the card
    (full width, a 4,096-row ring): one scatter per flush for all 5 ring
    keys, the two-hot and GRU counts of the gradient steps and player steps,
    one GRU step for each step of the end-of-run test episode, nothing
    else."""
    from sheeprl_tpu_torch import cli

    K.reset_launches()
    summary = cli.run(["preset=dreamer_v3_100k_atari_dummy_resident", "metric.log_level=0", "buffer.size=4096",
                       "algo.learning_starts=64", "algo.total_steps=66", "checkpoint.save_last=false",
                       f"log_root={tmp_path}"])
    G = summary["gradient_steps"]
    assert summary["device"].startswith("cuda") and summary["resident"] and G == 3 and summary["test_steps"] > 0
    assert np.isfinite(np.asarray(summary["metrics"])).all()
    assert K.LAUNCHES == {
        "gru_gates": G * (64 + 15) + summary["player_steps"] + summary["test_steps"], "two_hot_symlog_loss": 0,
        "two_hot_symlog_loss_lse": 3 * G, "two_hot_symlog_loss_lse_bwd": 3 * G,
        "two_hot_symexp_decode": 3 * G, "gae": 0, "sumtree_sample": 0,
        "ragged_ring_scatter": summary["replay"]["Replay/flushes"],
    }


def test_torch_cuda_async_ring_appends_at_column_offsets_match_plain(cuda):
    """``dreamer_sebulba``'s ring: blobs of two actors (4 envs each, 16 staged
    rows with ragged reset rows) appended at env columns 0 and 4 of a 24-row
    ring of the 5 DreamerV3 keys, interleaved until every column wraps: after
    every blob the card's storage and heads bit-equal to the same ring on the
    CPU (the plain version), one scatter launch per blob."""
    from sheeprl_tpu_torch.replay import AsyncSequenceRing
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    keys = dreamer_ring_keys({"rgb": {"shape": [64, 64, 3]}}, ["rgb"], [], [18], with_is_first=True)
    card, cpu = (AsyncSequenceRing(keys, 24, 8, 4, 16, 16, device=d) for d in (cuda, "cpu"))
    rng = np.random.default_rng(21)
    before = K.LAUNCHES["ragged_ring_scatter"]
    for i in range(8):
        off = 4 * (i % 2)
        rows = []
        for _ in range(int(rng.integers(4, 9))):
            row = {k: (rng.integers(0, 256, (4,) + s) if np.dtype(d) == np.uint8 else rng.normal(size=(4,) + s)).astype(d)
                   for k, (s, d) in keys.items()}
            rows.append((row, np.ones(4, np.int32)))
            done = (rng.random(4) < 0.4).astype(np.int32)
            if done.any():
                rows.append((row, done))
        blob = card.pack_rows(rows[:16], off)
        counts = np.zeros(8, np.int64)
        counts[off:off + 4] = sum(m for _, m in rows[:16])
        for ring in (card, cpu):
            ring.append(blob.to(ring.device), off)
            ring.note_append(counts, blob.numel())
        torch.cuda.synchronize()
        for k in keys:
            assert torch.equal(card.state["storage"][k].cpu(), cpu.state["storage"][k]), (i, k)
        assert torch.equal(card.state["pos"].cpu(), cpu.state["pos"]) and torch.equal(card.state["valid"].cpu(), cpu.state["valid"])
    assert K.LAUNCHES["ragged_ring_scatter"] == before + 8 and (card.host_valid == 24).all()


def test_torch_cuda_async_loop_launches_per_blob_and_step(cuda, tmp_path):
    """A short ``run preset=dreamer_sebulba_atari_dummy`` on the card (full
    width, B 4 x T 16, 2 actors x 4 envs): one scatter per committed blob,
    ``gru_gates`` once per act step and test step and T + H per gradient step,
    the two-hot kernels 3 per gradient step, nothing else."""
    from sheeprl_tpu_torch import cli

    K.reset_launches()
    summary = cli.run(["preset=dreamer_sebulba_atari_dummy", "metric.log_level=0", "buffer.size=4096",
                       "algo.learning_starts=64", "algo.total_steps=256", "algo.per_rank_batch_size=4",
                       "algo.per_rank_sequence_length=16", "algo.replay_ratio=0.125", "checkpoint.save_last=false",
                       f"log_root={tmp_path}"])
    G = summary["gradient_steps"]
    assert summary["device"].startswith("cuda") and G > 0 and summary["test_steps"] > 0 and summary["act_steps"] > 0
    assert np.isfinite(np.asarray(summary["metrics"])).all()
    assert K.LAUNCHES == {
        "gru_gates": summary["act_steps"] + G * (16 + 15) + summary["test_steps"], "two_hot_symlog_loss": 0,
        "two_hot_symlog_loss_lse": 3 * G, "two_hot_symlog_loss_lse_bwd": 3 * G,
        "two_hot_symexp_decode": 3 * G, "gae": 0, "sumtree_sample": 0,
        "ragged_ring_scatter": summary["replay"]["Replay/flushes"],
    }


def test_torch_cuda_eval_step_gru_gates_ln_matches_plain(cuda):
    """The evaluation and test-episode path's shape: one row, the
    (1, 1536) projection of DreamerV3-S's 512-wide GRU. The kernel against
    its plain version (f32 atol and rtol 1e-5), and the RSSM cell at batch 1
    on the card, one launch, against the cell on the CPU (TF32 off; atol
    1e-5)."""
    proj, h, w, b = (torch.from_numpy(a).to(cuda) for a in _ln_inputs(1, 512, seed=15))
    before = K.LAUNCHES["gru_gates"]
    got = K.gru_gates_ln(proj, h, w, b, 1e-3)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1 and got.shape == (1, 512)
    torch.testing.assert_close(got, K.gru_gates_ln_reference(proj, h, w, b, 1e-3), atol=1e-5, rtol=1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = LayerNormGRUCell(512, 512, use_bias=False, layer_norm=True)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(1, 512)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(1, 512)).astype(np.float32)).tanh()
    with torch.no_grad():
        want = cell(h, x)
        before = K.LAUNCHES["gru_gates"]
        got = cell.to(cuda)(h.to(cuda), x.to(cuda))
        torch.cuda.synchronize()
    assert K.LAUNCHES["gru_gates"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_torch_cuda_stateless_engine_batched_row_equals_row_alone(cuda, algo):
    """The bucket engine on the card at the presets' widths: every row of
    batches of 1 to 200 (200 chunked through bucket 128) equals the greedy
    program on that row alone, PPO's actions exactly and SAC's within atol
    1e-5 (float32 products at another batch size); no repo kernel runs."""
    from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo
    from sheeprl_tpu_torch.algos.sac.evaluate import serve_policy_sac
    from sheeprl_tpu_torch.config import apply_overrides, dotdict, preset
    from sheeprl_tpu_torch.envs import make_vector_env
    from sheeprl_tpu_torch.serve.engine import BucketEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(preset(algo), ["env.num_envs=1"])
    cfg["spaces"] = dotdict(make_vector_env(cfg, 0).spaces)
    policy = (serve_policy_ppo if algo == "ppo" else serve_policy_sac)(cfg, None, cuda)
    engine = BucketEngine(policy, buckets=(1, 8, 32, 128))
    rng = np.random.default_rng(17)
    K.reset_launches()
    for n in (1, 3, 8, 9, 31, 128, 200):
        raw = {"state": rng.normal(size=(n, 4 if algo == "ppo" else 3)).astype(np.float32)}
        obs = policy.prepare(raw, n)
        got = engine.infer(policy.params, obs)
        with torch.no_grad():
            alone = torch.cat([policy.greedy_fn(policy.params, {k: torch.from_numpy(v[i:i + 1]).to(cuda)
                                                                for k, v in obs.items()}) for i in range(n)]).cpu().numpy()
        if algo == "ppo":
            np.testing.assert_array_equal(got, alone, err_msg=f"batch {n}")
        else:
            np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5, err_msg=f"batch {n}")
    assert not any(K.LAUNCHES.values())
    assert engine.stats()["rows"] == 380 and engine.stats()["dispatches"] == 8


@pytest.mark.parametrize(
    "kernel",
    ["gru_gates", "two_hot_symlog_loss_lse", "two_hot_symlog_loss_lse_bwd", "two_hot_symexp_decode", "gae",
     "sumtree_sample", "ragged_ring_scatter"],
)
def test_torch_cuda_kernel_keeps_the_plain_non_finite_positions(cuda, kernel):
    """Each kernel of a guarded path, on inputs seeded with NaN, +inf and
    -inf at its main path's shape, gives non-finite outputs exactly where
    its plain version does (``chip_smoke.nonfinite_check``), so the finite
    guard sees on the card what it sees on the CPU: a row max or a clamp
    that drops a NaN must not turn a poisoned input into a finite loss."""
    import chip_smoke

    assert any(chip_smoke.nonfinite_check(kernel)["nonfinite_outputs"])


def test_torch_cuda_capturable_adam_guard_select(cuda):
    """Adam on the card is fused and capturable: its step counts live on the card,
    a guarded step whose gradients hold a NaN leaves the parameters, the
    moments and the step counts bit-equal, a finite one moves them as the
    CPU's Adam does on the same gradients (within 1e-6), and a state saved
    on the CPU loads with its step counts on the card."""
    from sheeprl_tpu_torch.ops.guard import StateGuard, finite_guard
    from sheeprl_tpu_torch.optim import build_optimizer

    cfg = {"_target_": "torch.optim.Adam", "lr": 1e-3, "eps": 1e-5}
    torch.manual_seed(0)
    models = {dev: torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 2)).to(dev)
              for dev in ("cpu", "cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    opts = {dev: build_optimizer(m.parameters(), cfg, max_grad_norm=0.5) for dev, m in models.items()}
    assert opts["cuda"].capturable and not opts["cpu"].capturable
    assert opts["cuda"].optimizer.param_groups[0]["fused"] and not opts["cpu"].optimizer.param_groups[0]["fused"]
    steps = [st["step"] for st in opts["cuda"].optimizer.state.values()]
    assert steps and all(s.is_cuda for s in steps)
    params = list(models["cuda"].parameters())
    guard = StateGuard(lambda: params + opts["cuda"].state_tensors())
    x = torch.randn(32, 6)
    for poisoned in (False, True, False):
        loss = models["cuda"](x.to(cuda)).square().mean()
        grads = {"cuda": list(torch.autograd.grad(loss, params))}
        grads["cpu"] = [g.cpu() for g in grads["cuda"]]
        if poisoned:
            grads["cuda"][1][3] = float("nan")
        guard.snapshot()
        before = [t.clone() for t in params + opts["cuda"].state_tensors()]
        ok = finite_guard(grads["cuda"])
        assert ok.is_cuda and bool(ok) is not poisoned
        opts["cuda"].step(grads["cuda"])
        guard.select(ok)
        after = params + opts["cuda"].state_tensors()
        if poisoned:
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            continue
        opts["cpu"].step(grads["cpu"])
        for a, b in zip(models["cuda"].parameters(), models["cpu"].parameters()):
            torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
    assert {int(s) for s in steps} == {2}
    fresh = build_optimizer(models["cuda"].parameters(), cfg, max_grad_norm=0.5)
    fresh.load_state_dict(opts["cpu"].state_dict())
    assert all(st["step"].is_cuda and int(st["step"]) == 2 for st in fresh.optimizer.state.values())


def test_torch_cuda_checkpoint_staging_is_ordered_before_later_writes(cuda):
    """``stage_to_host`` copies card tensors on a side stream into pinned
    buffers, and the caller's stream waits for the copies: an in-place
    update queued right after it (as the next optimizer step would be) does
    not reach the staged copy."""
    from sheeprl_tpu_torch.utils.checkpoint import finalize_host, stage_to_host

    live = {"w": torch.arange(1 << 22, dtype=torch.float32, device=cuda), "n": 3}
    staged = stage_to_host(live, copy_host=True)
    live["w"].mul_(-1.0)
    host = finalize_host(staged)
    assert host["w"].device.type == "cpu" and host["w"].is_pinned() and host["n"] == 3
    assert torch.equal(host["w"], torch.arange(1 << 22, dtype=torch.float32))


def test_torch_cuda_host_snapshot_copy_is_event_gated_and_isolated(cuda):
    """The hybrid player's snapshot: the pack is a fresh bf16 tensor on the
    card, copied into pinned memory without blocking; ``poll`` adopts it
    only once its event has completed (the card is kept busy with
    ``torch.cuda._sleep`` first), and an in-place update queued after the
    refresh does not reach it."""
    from sheeprl_tpu_torch.utils.burst import HostSnapshot

    torch.manual_seed(0)
    card = torch.nn.Linear(256, 512).to(cuda)
    host = torch.nn.Linear(256, 512)
    snap = HostSnapshot(list(card.parameters()), list(host.parameters()), torch.bfloat16)
    snap.pull()  # loads the pack's kernels: a kernel's first launch (lazy module loading) waits for the card
    want = [p.detach().to(torch.bfloat16).float().cpu() for p in card.parameters()]
    torch.cuda._sleep(200_000_000)  # the copy queues behind ~0.1 s of device work
    assert snap.refresh_async(version=3)
    assert not snap.refresh_async(version=4)  # a copy in flight: skipped
    with torch.no_grad():
        for p in card.parameters():
            p.add_(1.0)
    polled = snap.poll()
    torch.cuda.synchronize()
    assert polled is False or snap.host_version == 3
    while not polled:
        polled = snap.poll()
    assert snap.host_version == 3 and snap.pulls == 2
    for h, w in zip(host.parameters(), want):
        assert torch.equal(h, w)
    slot_host = snap.pack()
    assert slot_host.is_cuda and slot_host.dtype == torch.bfloat16


def test_torch_cuda_sac_burst_append_matches_cpu(cuda):
    """SAC's hybrid burst appends its staged rows on the card exactly as on
    the CPU: wrap-around at the ring's end, the padding rows dropped, no
    step granted (the parameters stay)."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_burst_train_step, make_optimizers
    from sheeprl_tpu_torch.config import apply_overrides, preset
    from sheeprl_tpu_torch.data.ring import pack_burst_blob

    cfg = apply_overrides(preset("sac"), ["algo.per_rank_batch_size=16"])
    C, E, S, G, count = 64, 4, 20, 8, 13
    dims = {"observations": 3, "next_observations": 3, "actions": 1, "rewards": 1, "terminated": 1}
    rng = np.random.default_rng(5)
    ring = {k: rng.normal(size=(C, E, d)).astype(np.float32) for k, d in dims.items()}
    values = {k: rng.normal(size=(S, E, d)).astype(np.float32) for k, d in dims.items()}
    values.update(__pos__=np.asarray(C - 5, np.int32), __count__=np.asarray(count, np.int32),
                  __valid_n__=np.asarray(C, np.int32), __flags__=np.zeros(G, np.float32),
                  __valid__=np.zeros(G, np.float32))
    out = {}
    for dev in ("cpu", cuda):
        agent, _ = build_agent(cfg, 3, {"shape": [1], "low": [-2.0], "high": [2.0]}, dev)
        before = {k: v.detach().cpu().clone() for k, v in agent.state_dict().items()}
        burst, layout = make_burst_train_step(agent, make_optimizers(cfg, agent), cfg, C, E, S, G, dims)
        rb = {k: torch.from_numpy(v.copy()).to(dev) for k, v in ring.items()}
        assert burst(rb, pack_burst_blob(layout, values, pin_memory=str(dev) != "cpu")) is None
        assert all(torch.equal(v.detach().cpu(), before[k]) for k, v in agent.state_dict().items())
        out[str(dev)] = {k: v.cpu() for k, v in rb.items()}
    for k in dims:
        assert torch.equal(out["cuda"][k], out["cpu"][k]), k
        written = torch.nonzero((out["cuda"][k] != torch.from_numpy(ring[k])).flatten(1).any(1)).flatten().tolist()
        assert written == list(range(8)) + list(range(C - 5, C)), k


@pytest.mark.parametrize("case", ["random", "no_window"])
def test_torch_cuda_episode_rule_table_and_draw_match_cpu(cuda, case):
    """The ring's episode rule (plain indexing, no kernel) on the card, at
    the Dreamer V2 presets' ring (25,000 rows x 4 envs, windows of 50),
    against the CPU: the table, its counts and the drawn windows bit for
    bit; ``no_window`` gives env 3 a boundary every other row (its
    sequential starts)."""
    from sheeprl_tpu_torch.data.ring import episode_window_table, sample_window_starts

    C, E, T = 25000, 4, 50
    rng = np.random.default_rng(7)
    is_first = (rng.random((C, E, 1)) < 0.01).astype(np.float32)
    if case == "no_window":
        is_first[::2, 3] = 1.0
    pos, valid = np.array([1234, 0, 20000, 777], np.int32), np.array([C, 9000, C, C], np.int32)
    cpu_in = [torch.from_numpy(a) for a in (pos, valid, is_first)]
    want = episode_window_table(*cpu_in, C, T)
    got = episode_window_table(*[t.to(cuda) for t in cpu_in], C, T)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if case == "no_window":
        assert int(want[1][3]) == C - T + 1
    gen = torch.Generator().manual_seed(3)
    env_idx, u = torch.randint(0, E, (1024,), generator=gen), torch.rand(1024, generator=gen)
    drawn = sample_window_starts(u.to(cuda), env_idx.to(cuda), *got, C, T)
    assert torch.equal(drawn.cpu(), sample_window_starts(u, env_idx, *want, C, T))


def test_torch_cuda_four_key_blob_append_matches_plain(cuda):
    """A flush of a ring built without ``is_first`` (Dreamer V1's rows: the
    pixels, actions, rewards and ``terminated``) through the burst program
    on the card: one ``ragged_ring_scatter_keys`` launch, the ring equal to
    the plain scatter's on the CPU bit for bit."""
    from sheeprl_tpu_torch.data.ring import build_burst_train_step, make_blob_layouts, pack_burst_blob
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    C, E, S = 64, 4, 22
    keys = dreamer_ring_keys({"rgb": {"shape": [64, 64, 3]}}, ["rgb"], [], [18], with_is_first=False)
    assert list(keys) == ["rgb", "actions", "rewards", "terminated"]
    spec = {"capacity": C, "n_envs": E, "grad_chunk": 6, "seq_len": 50, "batch_size": 4, "ring_keys": keys,
            "stage_buckets": (S,), "stage_max": S}
    rng = np.random.default_rng(11)
    values = {k: (rng.integers(0, 256, (S, E) + shape).astype(np.uint8) if dt == np.uint8
                  else rng.normal(size=(S, E) + shape).astype(np.float32)) for k, (shape, dt) in keys.items()}
    mask = (rng.random((S, E)) < 0.8).astype(np.int32)
    values.update({"__mask__": mask, "__pos__": np.array([60, 3, 0, 40], np.int32),
                   "__valid_n__": np.array([C, 3, 0, C], np.int32), "__validmask__": np.zeros(6, np.float32)})
    blob = pack_burst_blob(make_blob_layouts(keys, E, 6, (S,))[S], values)
    burst = build_burst_train_step(lambda c, xs: (c, torch.zeros(1)), spec, lambda g: None)
    ring = {k: (rng.integers(0, 256, (C, E) + shape).astype(np.uint8) if dt == np.uint8
                else rng.normal(size=(C, E) + shape).astype(np.float32)) for k, (shape, dt) in keys.items()}
    cpu_rb = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    card_rb = {k: torch.from_numpy(v.copy()).to(cuda) for k, v in ring.items()}
    burst(0, cpu_rb, blob)
    before = K.LAUNCHES["ragged_ring_scatter"]
    burst(0, card_rb, blob.pin_memory())
    torch.cuda.synchronize()
    assert K.LAUNCHES["ragged_ring_scatter"] == before + 1
    for k in keys:
        assert torch.equal(card_rb[k].cpu(), cpu_rb[k]), k
