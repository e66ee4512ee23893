"""The port's ``TruncatedNormal`` (Dreamer V2's ``trunc_normal`` actor head)
against the JAX package's, on the CPU: ``rsample`` on the uniforms
``jax.random.uniform`` draws from the same key (one draw per element, and
the greedy path's 100), its gradient in ``loc`` and ``scale`` against
``jax.grad``, ``log_prob`` (inside, at the bounds, at ±(1 - 1e-6) and
outside), ``entropy``, ``mean`` and ``mode``; then the V2 actor's
``actor_dists`` and ``actor_sample`` (every continuous head, greedy and
sampled) on the same head outputs and draws. Tolerance 1e-6 (relative and
absolute), float32 both sides.

One exception, measured: XLA's float32 ``erf`` is off by up to 2.3e-7 (it
gives 1 - 1.8e-7 where the true value rounds to 1), torch's saturates, so a
bound deep in a tail (``Phi(-9.5)``: JAX 8.9e-8, the port 0) moves the CDF
by up to ~1.2e-7, and a draw whose CDF value is that small moves by that
times the slope of the inverse CDF there (2.6e-5 at ``ndtri(2e-4)`` and
scale 0.2). Draws are held to JAX within 1e-6 plus that bound, and to a
float64 reference of the same formula within 1e-6 outright."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from sheeprl_tpu.algos.dreamer_v2.agent import Actor as JaxActor
from sheeprl_tpu.algos.dreamer_v2.agent import actor_dists as jax_actor_dists
from sheeprl_tpu.algos.dreamer_v2.agent import actor_sample as jax_actor_sample
from sheeprl_tpu.distributions import TruncatedNormal as JaxTruncatedNormal
from sheeprl_tpu_torch.algos.dreamer_v2.agent import GREEDY_SAMPLES, Actor, actor_dists, actor_sample
from sheeprl_tpu_torch.distributions import TruncatedNormal
from sheeprl_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-6, atol=1e-6)

# (loc, scale) pairs: centred, near either bound, narrow and wide
PARAMS = {
    "centred": (0.1, 0.5),
    "near_high": (0.97, 0.2),
    "near_low": (-0.99, 0.05),
    "narrow": (0.3, 0.01),
    "wide": (-0.2, 2.1),
}


def _arrays(case, n=6):
    loc, scale = PARAMS[case]
    rng = np.random.default_rng(len(case))
    locs = np.clip(loc + 0.01 * rng.normal(size=(n,)), -0.999, 0.999).astype(np.float32)
    scales = (scale * (1 + 0.1 * rng.random(n))).astype(np.float32)
    return locs, scales


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


#: XLA's float32 erf against the true erf (the largest gap over [-7, 7])
ERF_F32_ERR = 2.4e-7


def _check_draws(got, want, locs, scales, uniform):
    """``got`` against JAX's ``want`` within 1e-6 plus the inverse CDF's
    slope times the CDF error JAX's erf can carry, and against the float64
    formula within 1e-6."""
    z = (want.astype(np.float64) - locs) / scales
    slope = np.sqrt(2 * np.pi) * np.exp(np.minimum(z**2 / 2, 50.0))
    bound = 1e-6 + 1e-6 * np.abs(want) + scales * slope * ERF_F32_ERR
    assert (np.abs(got - want) <= bound).all(), float(np.max(np.abs(got - want) - bound))
    loc64, scale64 = locs.astype(np.float64), scales.astype(np.float64)
    phi_a, phi_b = scipy.special.ndtr((-1 - loc64) / scale64), scipy.special.ndtr((1 - loc64) / scale64)
    z = np.maximum(phi_b - phi_a, 1e-8)
    ref = loc64 + scale64 * scipy.special.ndtri(np.clip(phi_a + uniform * z, 1e-7, 1 - 1e-7))
    np.testing.assert_allclose(got, np.clip(ref, -1 + 1e-6, 1 - 1e-6), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_torch_truncated_normal_rsample_matches_jax(case):
    locs, scales = _arrays(case)
    key = jax.random.PRNGKey(len(case))
    want = np.asarray(JaxTruncatedNormal(jnp.asarray(locs), jnp.asarray(scales)).sample(key))
    uniform = np.asarray(jax.random.uniform(key, locs.shape))
    got = TruncatedNormal(_t(locs), _t(scales)).rsample(uniform=_t(uniform))
    _check_draws(got.numpy(), want, locs, scales, uniform)
    assert (got.numpy() >= -1 + 1e-6).all() and (got.numpy() <= 1 - 1e-6).all()


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_torch_truncated_normal_many_draws_match_jax(case):
    locs, scales = _arrays(case)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JaxTruncatedNormal(jnp.asarray(locs), jnp.asarray(scales)).sample(key, (GREEDY_SAMPLES,)))
    uniform = np.asarray(jax.random.uniform(key, (GREEDY_SAMPLES,) + locs.shape))
    got = TruncatedNormal(_t(locs), _t(scales)).rsample(uniform=_t(uniform))
    assert got.shape == (GREEDY_SAMPLES,) + locs.shape
    _check_draws(got.numpy(), want, locs, scales, uniform)


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_torch_truncated_normal_rsample_gradient_matches_jax(case):
    locs, scales = _arrays(case)
    key = jax.random.PRNGKey(3)
    uniform = np.asarray(jax.random.uniform(key, locs.shape))
    weights = np.linspace(-1, 1, locs.size).astype(np.float32)

    def jax_fn(loc, scale):
        return jnp.sum(JaxTruncatedNormal(loc, scale).sample(key) * weights)

    want = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(locs), jnp.asarray(scales))
    loc, scale = _t(locs).requires_grad_(True), _t(scales).requires_grad_(True)
    (TruncatedNormal(loc, scale).rsample(uniform=_t(uniform)) * _t(weights)).sum().backward()
    np.testing.assert_allclose(loc.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scale.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_torch_truncated_normal_log_prob_entropy_mean_mode_match_jax(case):
    locs, scales = _arrays(case, n=8)
    values = np.array([-1.0, -1 + 1e-6, -0.5, 0.0, 0.4, 1 - 1e-6, 1.0, 1.2], np.float32)
    jd = JaxTruncatedNormal(jnp.asarray(locs), jnp.asarray(scales))
    d = TruncatedNormal(_t(locs), _t(scales))
    want_lp, got_lp = np.asarray(jd.log_prob(jnp.asarray(values))), d.log_prob(_t(values)).numpy()
    np.testing.assert_array_equal(np.isinf(got_lp), np.isinf(want_lp))  # -inf outside [low, high]
    finite = np.isfinite(want_lp)
    np.testing.assert_allclose(got_lp[finite], want_lp[finite], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(d.entropy().numpy(), np.asarray(jd.entropy()), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(d.mean.numpy(), np.asarray(jd.mean), **TOL)
    np.testing.assert_allclose(d.mode.numpy(), np.asarray(jd.mode), **TOL)


def test_torch_truncated_normal_rejects_bad_bounds_and_noise():
    with pytest.raises(ValueError, match="low"):
        TruncatedNormal(torch.zeros(2), torch.ones(2), 1.0, -1.0)
    with pytest.raises(ValueError, match="uniform noise"):
        TruncatedNormal(torch.zeros(2), torch.ones(2)).rsample(uniform=torch.zeros(3))


# -- the V2 actor's continuous heads --------------------------------------------------------

N_ACT, ROWS, LATENT = 3, 5, 12


def _actors(distribution):
    jax_actor = JaxActor(actions_dim=(N_ACT,), is_continuous=True, distribution=distribution, dense_units=16,
                         mlp_layers=2, init_std=0.0, min_std=0.1)
    params = jax_actor.init(jax.random.PRNGKey(1), jnp.zeros((1, LATENT)))
    port = Actor(LATENT, (N_ACT,), 16, 2, is_continuous=True, distribution=distribution, init_std=0.0, min_std=0.1)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return jax_actor, params, port


STATE = np.random.default_rng(2).normal(size=(ROWS, LATENT)).astype(np.float32)


@pytest.mark.parametrize("distribution", ["trunc_normal", "normal", "tanh_normal"])
def test_torch_truncated_normal_actor_dists_match_jax(distribution):
    jax_actor, params, port = _actors(distribution)
    want = jax_actor_dists(jax_actor, jax_actor.apply(params, jnp.asarray(STATE)))[0]
    got = actor_dists(port, port(_t(STATE)))[0]
    values = np.random.default_rng(3).uniform(-0.9, 0.9, (ROWS, N_ACT)).astype(np.float32)
    np.testing.assert_allclose(got.log_prob(_t(values)).detach().numpy(), np.asarray(want.log_prob(values)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.mode.detach().numpy(), np.asarray(want.mode), **TOL)
    if distribution != "tanh_normal":  # no closed-form entropy on either side
        np.testing.assert_allclose(got.entropy().detach().numpy(), np.asarray(want.entropy()), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("distribution", ["trunc_normal", "normal", "tanh_normal"])
def test_torch_truncated_normal_actor_sample_matches_jax(distribution, greedy):
    """A sampled action on the key's own draw; a greedy one, the highest
    log-prob of 100 draws, on the same 100 draws."""
    jax_actor, params, port = _actors(distribution)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_actor_sample(jax_actor, params, jnp.asarray(STATE), key, greedy=greedy)[0][0])
    shape = ((GREEDY_SAMPLES,) if greedy else ()) + (ROWS, N_ACT)
    draw = jax.random.uniform if distribution == "trunc_normal" else jax.random.normal
    got = actor_sample(port, _t(STATE), [_t(draw(key, shape))], greedy=greedy)[0][0]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
