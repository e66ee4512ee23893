"""The port's blocks, distributions and RL math against the JAX package's,
under flax weights carried across by ``sheeprl_tpu_torch.utils.convert``.

Tolerances: f32 modules within atol 1e-5. flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 and torch's in two passes, which differ by about
1e-6 relative; the rest is the same float32 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.distributions import OneHotCategoricalStraightThrough as JaxOHCST
from sheeprl_tpu.models import MLP as JaxMLP
from sheeprl_tpu.models import LayerNormGRUCell as JaxGRUCell
from sheeprl_tpu.ops.core import symexp as jax_symexp
from sheeprl_tpu.ops.core import symlog as jax_symlog
from sheeprl_tpu_torch.distributions import OneHotCategorical, OneHotCategoricalStraightThrough
from sheeprl_tpu_torch.models import MLP, LayerNormGRUCell, get_activation
from sheeprl_tpu_torch.ops import counter_uniform, symexp, symlog
from sheeprl_tpu_torch.utils.convert import flax_to_state_dict

ATOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize(
    "hidden, act, ln",
    [((16, 16), "silu", True), ((8,), "torch.nn.Tanh", False), ((12, 4), "relu", True)],
    ids=["silu-ln", "tanh", "relu-ln"],
)
def test_torch_mlp_matches_flax(hidden, act, ln):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 10)).astype(np.float32)
    jm = JaxMLP(hidden_sizes=hidden, activation=act, layer_norm=ln)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # non-trivial LayerNorm affine, so the scale -> weight mapping is exercised
    params = jax.tree.map(lambda a: a + 0.1 * np.random.default_rng(2).normal(size=a.shape).astype(np.float32), params)
    want = _np(jm.apply(params, jnp.asarray(x)))
    tm = MLP(10, hidden, activation=act, layer_norm=ln)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("jax_backend", ["lax", "pallas"])
@pytest.mark.parametrize("use_bias, layer_norm", [(False, True), (True, False)], ids=["rssm-cell", "plain-cell"])
def test_torch_layernorm_gru_cell_matches_flax(jax_backend, use_bias, layer_norm):
    """The flax cell through both JAX tiers (the Pallas one in interpret
    mode) against the port's cell, whose gate chain is the plain version
    on the CPU."""
    from sheeprl_tpu.ops.kernels import registry

    rng = np.random.default_rng(3)
    H, X, B = 16, 12, 6
    x = rng.normal(size=(B, X)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    jc = JaxGRUCell(hidden_size=H, use_bias=use_bias, layer_norm=layer_norm)
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    with registry.use_backend(jax_backend):
        want, _ = jc.apply(params, jnp.asarray(h), jnp.asarray(x))
    tc = LayerNormGRUCell(X, H, use_bias=use_bias, layer_norm=layer_norm)
    tc.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tc(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=ATOL)


def test_torch_symlog_symexp_match_jax():
    x = np.random.default_rng(4).normal(scale=20.0, size=(64,)).astype(np.float32)
    np.testing.assert_allclose(symlog(torch.from_numpy(x)).numpy(), _np(jax_symlog(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    y = np.clip(x, -10, 10)
    np.testing.assert_allclose(symexp(torch.from_numpy(y)).numpy(), _np(jax_symexp(jnp.asarray(y))), rtol=1e-5, atol=1e-5)


def test_torch_onehot_mode_probs_logprob_match_jax():
    logits = np.random.default_rng(5).normal(size=(4, 3, 9)).astype(np.float32)
    jd = JaxOHCST(logits=jnp.asarray(logits))
    td = OneHotCategoricalStraightThrough(torch.from_numpy(logits))
    np.testing.assert_array_equal(td.mode.numpy(), _np(jd.mode))
    np.testing.assert_allclose(td.probs.numpy(), _np(jd.probs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.entropy().numpy(), _np(jd.entropy()), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.log_prob(td.mode).numpy(), _np(jd.log_prob(jd.mode)), rtol=1e-6, atol=1e-6)


def test_torch_onehot_sample_is_gumbel_max_of_the_given_noise():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, size=(5, 7)).astype(np.float32)
    want = np.argmax(logits - np.log(-np.log(u)), axis=-1)
    d = OneHotCategoricalStraightThrough(torch.from_numpy(logits))
    hard = OneHotCategorical(torch.from_numpy(logits)).sample(uniform=torch.from_numpy(u))
    st = d.rsample(uniform=torch.from_numpy(u))
    np.testing.assert_array_equal(hard.argmax(-1).numpy(), want)
    # straight-through: the forward value is the hard draw up to one ulp
    np.testing.assert_allclose(st.detach().numpy(), hard.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="uniform noise"):
        d.rsample(uniform=torch.from_numpy(u[:2]))
    g = torch.Generator().manual_seed(0)
    assert d.sample(generator=g).sum().item() == pytest.approx(5.0, abs=1e-5)


def test_torch_counter_uniform_is_per_row_and_in_range():
    seed = torch.tensor([5, 5, 7, -3], dtype=torch.int64)
    counter = torch.tensor([0, 1, 0, 2**40], dtype=torch.int64)
    u = counter_uniform(seed, counter, 0, 1000)
    assert u.shape == (4, 1000) and u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    # a row depends on its own (seed, counter, stream) only
    alone = counter_uniform(seed[1:2], counter[1:2], 0, 1000)
    assert torch.equal(alone[0], u[1])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], counter_uniform(seed[:1], counter[:1], 1, 1000)[0])


def test_torch_get_activation_names():
    assert get_activation("torch.nn.SiLU") is get_activation("silu")
    with pytest.raises(ValueError, match="Unknown activation"):
        get_activation("nope")
