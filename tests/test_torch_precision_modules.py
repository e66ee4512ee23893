"""``fabric.precision`` in the port's layers, blocks, GRU cell and
distributions against the JAX package's flax modules, on the CPU.

The policy: each JAX alias maps to the same parameter and compute dtypes,
and an unknown one raises the same ``ValueError``. Under ``bf16-mixed`` each
port layer computes as flax's with ``dtype=bfloat16`` (float32 parameters,
inputs and weights cast, products rounded, LayerNorm statistics and affine in
float32 and rounded once), and the RSSM cell's ``gru_gates_ln`` plain version
computes what flax's LayerNorm and the Pallas kernel (interpret mode, as the
TPU runs it) compute, for a bfloat16 carry and for the float32 carry a
player's state starts from.

Tolerances, single modules (bfloat16 has 8 bits of mantissa): the output
dtypes equal; at least 99 % of the elements bit-equal; every element within
2 bf16 ulps (``_ulps``: the distance of the two bit patterns), within 1 ulp
for the GRU cell. A float32 output of the cell over a float32 carry is held
to 1e-6 on 99 % of its elements (the gate math's float32 rounding) and to one
bf16 ulp of the normalised projection (2^-8 relative, 1e-6 absolute) on all.
What each comparison measured is in its assertion message. Activations are
those whose bfloat16 results XLA's CPU backend and torch round alike (relu,
tanh, elu); silu's ``logistic`` XLA's CPU backend expands into three bf16
roundings where torch rounds once, so the silu blocks are held at the agent
bounds of ``tests/test_torch_precision_v3.py``. Distributions: samples,
modes and means in the parameters' dtype, log-probs, entropies and KLs
float32 within 1e-6 absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.models import MLP as JaxMLP
from sheeprl_tpu.models import LayerNormGRUCell as JaxGRUCell
from sheeprl_tpu.models import NatureCNN as JaxNatureCNN
from sheeprl_tpu.models.blocks import _ConvTranspose
from sheeprl_tpu.ops.kernels import registry
from sheeprl_tpu.parallel.fabric import _PRECISION_ALIASES
from sheeprl_tpu.parallel.fabric import Precision as JaxPrecision
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.models import (
    MLP, ConvTranspose, Dense, LayerNorm, LayerNormGRUCell, NatureCNN, set_compute_dtype,
)
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.parallel import PRECISION_ALIASES, Precision
from sheeprl_tpu_torch.utils.convert import flax_to_state_dict

BF16 = torch.bfloat16


def _ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """Per element, the distance in bf16 steps between two bf16 tensors."""
    w = torch.from_numpy(np.array(want, np.float32)).to(BF16)
    assert got.dtype == BF16
    return np.abs(_ordered(got) - _ordered(w))


def _ordered(t: torch.Tensor) -> np.ndarray:
    bits = t.contiguous().view(torch.int16).numpy().astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)  # sign-magnitude -> a line


def check_bf16(got: torch.Tensor, want, max_ulps: int = 2, what: str = ""):
    assert str(np.asarray(want).dtype) == "bfloat16", f"{what}: JAX output is {np.asarray(want).dtype}"
    want32 = np.asarray(jnp.asarray(want, jnp.float32))
    ulps = _ulps(got, want32)
    share = float(np.mean(ulps == 0))
    assert share >= 0.99, f"{what}: {share:.4f} of the elements bit-equal (bound 0.99)"
    assert int(ulps.max()) <= max_ulps, f"{what}: worst {int(ulps.max())} bf16 ulps (bound {max_ulps})"


def flax_like_params(shapes, seed: int = 0, jitter: float = 0.0):
    """Parameters in ``shapes`` (a tree of ``ShapeDtypeStruct``, as
    ``jax.eval_shape`` of an init gives, which compiles nothing) drawn as
    flax's defaults draw them: kernels normal with variance 1 / fan-in,
    LayerNorm scales 1, everything else 0; ``jitter`` adds that much of a
    standard normal to the scales and biases. Each must be float32: no JAX
    ``build_agent`` passes a parameter dtype."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        assert s.dtype == jnp.float32, f"{name}: a JAX parameter in {s.dtype}"
        if name == "kernel":
            fan_in = s.shape[-2] if len(s.shape) == 3 else int(np.prod(s.shape[:-1]))  # 3-d: stacked members
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = np.full(s.shape, 1.0 if name == "scale" else 0.0, np.float32)
        return (base + jitter * rng.normal(size=s.shape)).astype(np.float32) if jitter else base

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(module, seed, *args):
    return flax_like_params(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args), seed, jitter=0.1)


# -- the policy ---------------------------------------------------------------------


@pytest.mark.parametrize("alias", sorted(_PRECISION_ALIASES))
def test_torch_precision_alias_maps_as_jax(alias):
    want, got = JaxPrecision.from_string(alias), Precision.from_string(alias)
    assert str(got.param_dtype).split(".")[-1] == str(want.param_dtype)
    assert str(got.compute_dtype).split(".")[-1] == str(want.compute_dtype)
    assert set(PRECISION_ALIASES) == set(_PRECISION_ALIASES)


def test_torch_precision_unknown_alias_raises_jax_error():
    with pytest.raises(ValueError) as want:
        JaxPrecision.from_string("nonsense")
    with pytest.raises(ValueError) as got:
        Precision.from_string("nonsense")
    assert str(got.value) == str(want.value)


# -- layers and blocks --------------------------------------------------------------


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no-bias"])
def test_torch_precision_dense_matches_flax(use_bias):
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 24)).astype(np.float32)
    jm = fnn.Dense(40, use_bias=use_bias, dtype=jnp.bfloat16)
    params = _params(jm, 1, x)
    tm = Dense(24, 40, bias=use_bias)
    tm.load_state_dict(flax_to_state_dict(params))
    tm.dtype = BF16
    with torch.no_grad():
        check_bf16(tm(torch.from_numpy(x)), jm.apply(params, x), what="Dense")
    assert tm.weight.dtype == torch.float32


def test_torch_precision_layer_norm_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(16, 48)) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = fnn.LayerNorm(epsilon=1e-3, dtype=jnp.bfloat16)
    params = _params(jm, 2, xb)
    tm = LayerNorm(48, eps=1e-3)
    tm.load_state_dict(flax_to_state_dict(params))
    tm.dtype = BF16
    with torch.no_grad():
        check_bf16(tm(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(BF16)), jm.apply(params, xb),
                   what="LayerNorm")


@pytest.mark.parametrize(
    "hidden, act, ln", [((16, 16), "relu", True), ((8,), "tanh", False), ((12, 4), "elu", True)],
    ids=["relu-ln", "tanh", "elu-ln"],
)
def test_torch_precision_mlp_matches_flax(hidden, act, ln):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, 10)).astype(np.float32)
    jm = JaxMLP(hidden_sizes=hidden, activation=act, layer_norm=ln, dtype=jnp.bfloat16)
    params = _params(jm, 3, x)
    tm = set_compute_dtype(MLP(10, hidden, activation=act, layer_norm=ln), BF16)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        check_bf16(tm(torch.from_numpy(x)), jm.apply(params, x), what=f"MLP {hidden} {act}")


def test_torch_precision_nature_cnn_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    jm = JaxNatureCNN(features_dim=32, dtype=jnp.bfloat16)
    params = _params(jm, 4, x)
    tm = set_compute_dtype(NatureCNN(3, 64, features_dim=32), BF16)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        check_bf16(tm(torch.from_numpy(x)), jm.apply(params, x), what="NatureCNN")


def test_torch_precision_conv_transpose_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    jm = _ConvTranspose(features=5, kernel_size=(4, 4), strides=(2, 2), padding=1, dtype=jnp.bfloat16)
    params = _params(jm, 5, x)
    tm = set_compute_dtype(ConvTranspose(6, 5, 4, 2, padding=1), BF16)
    kernel = np.asarray(params["params"]["ConvTranspose_0"]["kernel"])
    tm.ConvTranspose_0.weight.data = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    tm.ConvTranspose_0.bias.data = torch.from_numpy(np.asarray(params["params"]["ConvTranspose_0"]["bias"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    check_bf16(got, jm.apply(params, x), what="ConvTranspose")


# -- the RSSM cell and gru_gates_ln's bf16 entry -----------------------------------


def _cell(carry_dtype):
    rng = np.random.default_rng(5)
    H, X, B = 64, 24, 12
    x = rng.normal(size=(B, X)).astype(np.float32)
    h = np.tanh(rng.normal(size=(B, H))).astype(np.float32)
    jc = JaxGRUCell(hidden_size=H, use_bias=False, layer_norm=True, use_pallas=True, dtype=jnp.bfloat16)
    hj = jnp.asarray(h, carry_dtype)
    params = _params(jc, 6, hj, jnp.asarray(x, jnp.bfloat16))
    with registry.use_backend("pallas"):
        want, _ = jc.apply(params, hj, jnp.asarray(x, jnp.bfloat16))
    tc = set_compute_dtype(LayerNormGRUCell(X, H, use_bias=False, layer_norm=True), BF16)
    tc.load_state_dict(flax_to_state_dict(params))
    th = torch.from_numpy(np.asarray(hj.astype(jnp.float32))).to(BF16 if carry_dtype == jnp.bfloat16 else torch.float32)
    with torch.no_grad():
        got = tc(th, torch.from_numpy(x).to(BF16))
    return got, want


def test_torch_precision_gru_cell_bf16_carry_matches_flax_and_pallas():
    got, want = _cell(jnp.bfloat16)
    check_bf16(got, want, max_ulps=1, what="LayerNormGRUCell, bf16 carry")


def test_torch_precision_gru_cell_f32_carry_matches_flax_and_pallas():
    got, want = _cell(jnp.float32)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(got.numpy() - want)
    assert float(np.mean(err <= 1e-6)) >= 0.99, f"{float(np.mean(err <= 1e-6)):.4f} within 1e-6 (bound 0.99)"
    assert float(np.max(err - 2.0**-8 * np.abs(want))) <= 1e-6, f"worst error {float(err.max())}"


def test_torch_precision_gru_ln_plain_version_takes_a_float32_affine():
    """The bf16 entry's plain version: the affine must be float32 (the
    parameter dtype), the output has the carry's dtype, and a mix the kernel
    does not take raises on the CPU as on the card."""
    rng = np.random.default_rng(7)
    proj = torch.from_numpy(rng.normal(size=(3, 24)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    w, b = torch.ones(24), torch.zeros(24)
    assert K.gru_gates_ln(proj.to(BF16), h.to(BF16), w, b, 1e-3).dtype == BF16
    assert K.gru_gates_ln(proj.to(BF16), h, w, b, 1e-3).dtype == torch.float32
    with pytest.raises(TypeError, match="float32 weight"):
        K.gru_gates_ln(proj.to(BF16), h.to(BF16), w.to(BF16), b, 1e-3)
    with pytest.raises(TypeError, match="projection"):
        K.gru_gates_ln(proj, h.to(BF16), w, b, 1e-3)
    # the float32 entry is the plain LayerNorm and chain, as before
    want = K.gru_gates_reference(torch.nn.functional.layer_norm(proj, (24,), w, b, 1e-3), h)
    assert torch.equal(K.gru_gates_ln(proj, h, w, b, 1e-3), want)


def test_torch_precision_gru_ln_gradient_is_the_bf16_chain():
    """The bf16 entry's backward is the LayerNorm and the gate chain in the
    input dtype, as the JAX ``custom_vjp`` differentiates its jnp chain:
    against ``jax.vjp`` of flax's LayerNorm and ``gru_gates_reference`` on
    the same bf16 values, each gradient's cosine similarity to JAX's at
    least 0.999 and every element within 2^-6 of its largest (the
    LayerNorm's backward sums over the row, so a small element carries the
    rounding of the large ones)."""
    import flax.linen as fnn
    from sheeprl_tpu.ops.kernels.gru import gru_gates_reference as jax_chain

    rng = np.random.default_rng(8)
    proj = jnp.asarray(rng.normal(size=(6, 48)) * 2, jnp.bfloat16)
    h = jnp.asarray(np.tanh(rng.normal(size=(6, 16))), jnp.bfloat16)
    ln = fnn.LayerNorm(epsilon=1e-3, dtype=jnp.bfloat16)
    params = _params(ln, 9, proj)
    cot = jnp.asarray(rng.normal(size=(6, 16)), jnp.bfloat16)
    def vjp(p, hh, prm, c):
        return jax.vjp(lambda p, hh, prm: jax_chain(ln.apply(prm, p), hh), p, hh, prm)[1](c)

    gp, gh, gprm = jax.jit(vjp)(proj, h, params, cot)
    tp = torch.from_numpy(np.asarray(proj.astype(jnp.float32))).to(BF16).requires_grad_(True)
    th = torch.from_numpy(np.asarray(h.astype(jnp.float32))).to(BF16).requires_grad_(True)
    w = torch.from_numpy(np.asarray(params["params"]["scale"])).requires_grad_(True)
    b = torch.from_numpy(np.asarray(params["params"]["bias"])).requires_grad_(True)
    K.gru_gates_ln(tp, th, w, b, 1e-3).backward(torch.from_numpy(np.asarray(cot.astype(jnp.float32))).to(BF16))
    for name, got, want in (("proj", tp.grad, gp), ("h", th.grad, gh), ("scale", w.grad, gprm["params"]["scale"]),
                            ("bias", b.grad, gprm["params"]["bias"])):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        got = got.float().numpy()
        assert got.dtype == np.float32
        err = np.abs(got - want)
        assert float(np.max(err)) <= 2.0**-6 * float(np.abs(want).max()), f"{name}: worst {float(err.max())}"
        cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= 0.999, f"{name}: cosine {cos}"


# -- distributions ------------------------------------------------------------------


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _jbf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _same(got, want, what):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), f"{what}: {got.dtype} against {want.dtype}"
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=1e-6, atol=1e-6, err_msg=what)


def test_torch_precision_distributions_lift_as_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(4, 3, 8)).astype(np.float32)
    loc, scale = rng.normal(size=(4, 3)).astype(np.float32), rng.uniform(0.2, 1.5, (4, 3)).astype(np.float32)
    value = rng.uniform(-0.9, 0.9, (4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def jax_side(logits, loc, scale, value, key):
        """Every JAX number below, under one jit (the lifted math is float32,
        and the casts back to bf16 are the same fused or not)."""
        lg, lo, sc = (jnp.asarray(a, jnp.bfloat16) for a in (logits, loc, scale))
        jd, jn = JD.OneHotCategoricalStraightThrough(logits=lg), JD.Normal(lo, sc)
        jt, jtn = JD.TanhNormal(lo, sc), JD.TruncatedNormal(lo, sc)
        jb = JD.BernoulliSafeMode(logits=lo)
        kl = JD.kl_divergence(JD.Independent(jd, 1), JD.Independent(JD.OneHotCategorical(logits=lg[::-1]), 1))
        return {"one-hot mode": jd.mode, "one-hot entropy": jd.entropy(), "one-hot log_prob": jd.log_prob(jd.mode),
                "one-hot KL": kl, "Normal log_prob": jn.log_prob(value), "Normal entropy": jn.entropy(),
                "Normal mean": jn.mean, "Normal draw": jn.sample(key), "TanhNormal draw": jt.sample(key),
                "TanhNormal mode": jt.mode, "TanhNormal log_prob": jt.log_prob(value.astype(jnp.bfloat16)),
                "TruncatedNormal mode": jtn.mode, "TruncatedNormal log_prob": jtn.log_prob(value),
                "TruncatedNormal entropy": jtn.entropy(), "Bernoulli mode": jb.mode,
                "Bernoulli log_prob": jb.log_prob((value > 0).astype(jnp.float32))}

    want = jax.jit(jax_side)(logits, loc, scale, value, key)
    td = TD.OneHotCategoricalStraightThrough(_bf(logits))
    tn, tt, ttn, tb = (TD.Normal(_bf(loc), _bf(scale)), TD.TanhNormal(_bf(loc), _bf(scale)),
                       TD.TruncatedNormal(_bf(loc), _bf(scale)), TD.BernoulliSafeMode(_bf(loc)))
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 3))))
    got = {"one-hot mode": td.mode, "one-hot entropy": td.entropy(), "one-hot log_prob": td.log_prob(td.mode),
           "one-hot KL": TD.kl_divergence(TD.Independent(td, 1),
                                          TD.Independent(TD.OneHotCategorical(_bf(logits[::-1].copy())), 1)),
           "Normal log_prob": tn.log_prob(torch.from_numpy(value)), "Normal entropy": tn.entropy(),
           "Normal mean": tn.mean, "Normal draw": tn.rsample(noise=noise), "TanhNormal draw": tt.rsample(noise=noise),
           "TanhNormal mode": tt.mode, "TanhNormal log_prob": tt.log_prob(_bf(value)), "TruncatedNormal mode": ttn.mode,
           "TruncatedNormal log_prob": ttn.log_prob(torch.from_numpy(value)), "TruncatedNormal entropy": ttn.entropy(),
           "Bernoulli mode": tb.mode, "Bernoulli log_prob": tb.log_prob(torch.from_numpy((value > 0).astype(np.float32)))}
    for what, w in want.items():
        _same(got[what], w, what)
    u = rng.uniform(1e-6, 1 - 1e-6, size=logits.shape).astype(np.float32)
    assert td.rsample(uniform=torch.from_numpy(u)).dtype == BF16


def test_torch_precision_two_hot_kernels_take_float32_logits():
    """The two-hot distribution lifts bf16 head logits before its kernels, so
    the kernels' inputs and outputs are float32 as JAX's Pallas kernels'
    (interpret mode): mean and log-prob within 1e-5 relative."""
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(6, 255)) * 2).astype(np.float32)
    target = (rng.normal(size=(6, 1)) * 5).astype(np.float32)
    with registry.use_backend("pallas"):
        jd = JD.TwoHotEncodingDistribution(_jbf(logits), dims=1)
        want_mean, want_lp = np.asarray(jd.mean), np.asarray(jd.log_prob(target))
    td = TD.TwoHotEncodingDistribution(_bf(logits))
    assert td.raw_logits.dtype == torch.float32
    got_mean, got_lp = td.mean, td.log_prob(torch.from_numpy(target))
    assert got_mean.dtype == torch.float32 and want_mean.dtype == np.float32
    np.testing.assert_allclose(got_mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)
