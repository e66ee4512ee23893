"""The port's decoupled RSSM (``algo.world_model.decoupled_rssm``: the
representation model reads the embedded observation alone) against the JAX
package's, on the CPU, at the tiny pixel+vector size of
``tests/test_torch_rssm_train.py``: the representation's input width and the
converted weights; the dynamic rollout (every posterior from one pass over
the T embeddings, the recurrent scan reading them shifted by one step with
zeros at step 0, the ``is_first`` restarts); and whole gradient steps of
JAX's ``make_train_step`` on JAX's draws, with a continuous and with a
discrete actor (the helpers and tolerances of
``tests/test_torch_rssm_continuous.py``). The rollout's states within 1e-5
and its sampled posteriors the same draws (equal once rounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent, sample_stochastic
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_continuous import (
    B,
    T,
    _port_cfg,
    _t,
    _uniform,
    build_jax,
    check_actor_grads,
    check_metrics,
    check_params,
    step_batch,
    step_pair,
)

DECOUPLED = ["algo.world_model.decoupled_rssm=True"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    return build_jax(DECOUPLED)


@pytest.fixture(scope="module")
def pairs(built):
    return {kind: step_pair(built, continuous=kind == "continuous", seed=13) for kind in ("continuous", "discrete")}


def _representation_width(plain, decoupled: bool) -> int:
    plain = dict(plain)
    plain["algo"] = {**plain["algo"], "world_model": {**plain["algo"]["world_model"], "decoupled_rssm": decoupled}}
    wm = build_training_agent(_port_cfg(plain, True), "cpu")[0]
    return wm.representation_model.model.dense_0.in_features


def test_torch_rssm_decoupled_representation_reads_the_embedding_alone(built):
    """The representation's input is the embedding alone, as wide as JAX's
    kernel, the recurrent state narrower than the coupled model's; the
    converted weights load strictly."""
    cfg = built["cfg"]
    wm = build_training_agent(_port_cfg(built["plain"], True), "cpu", dreamer_v3_state_from_jax(built["params"]))[0]
    assert wm.decoupled
    width = wm.representation_model.model.dense_0.in_features
    jax_kernel = built["params"]["world_model"]["representation_model"]["params"]["model"]["dense_0"]["kernel"]
    assert width == jax_kernel.shape[0] == _representation_width(built["plain"], True)
    rec = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    assert _representation_width(built["plain"], False) == width + rec


def test_torch_rssm_decoupled_dynamic_rollout_matches_jax(built):
    """The decoupled rollout, step by step, against the JAX RSSM's
    ``_representation`` over all T embeddings and ``dynamic_decoupled`` over
    the shifted posteriors, from the same embeddings, actions, restarts and
    draws."""
    cfg, params = built["cfg"], built["params"]
    rssm = built["world_model"].rssm
    wmp = jax.tree.map(jnp.asarray, params["world_model"])
    wm = build_training_agent(_port_cfg(built["plain"], True), "cpu", dreamer_v3_state_from_jax(params))[0]
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    R = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    data = step_batch(True)
    rng = np.random.default_rng(1)
    embedded = rng.normal(size=(T, B, wm.representation_model.model.dense_0.in_features)).astype(np.float32)
    actions = data["actions"][0]
    is_first = data["is_first"][0].copy()
    is_first[0] = 1.0
    key = jax.random.PRNGKey(9)

    want_logits, want_posts = rssm._representation(wmp, None, jnp.asarray(embedded), key)
    posts_prev = jnp.concatenate([jnp.zeros_like(want_posts[:1]), want_posts[:-1]], axis=0)
    rec = jnp.zeros((B, R))
    want_recs, want_priors = [], []
    for t in range(T):
        rec, prior = rssm.dynamic_decoupled(wmp, posts_prev[t], rec, jnp.asarray(actions[t]), jnp.asarray(is_first[t]))
        want_recs.append(np.asarray(rec))
        want_priors.append(np.asarray(prior))

    with torch.no_grad():
        got_logits = wm.representation(None, _t(embedded))
        got_posts = sample_stochastic(got_logits, D, _t(_uniform(key, (T, B, S, D)).reshape(T, B, S * D)))
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-5)
        np.testing.assert_array_equal(np.round(got_posts.numpy()), np.round(np.asarray(want_posts)))
        prev = torch.cat([torch.zeros_like(got_posts[:1]), got_posts[:-1]], dim=0)
        rec_t = torch.zeros((B, R))
        initial = wm.get_initial_states(B)
        for t in range(T):
            rec_t, prior_t = wm.dynamic_decoupled(prev[t], rec_t, _t(actions[t]), _t(is_first[t]), initial)
            np.testing.assert_allclose(rec_t.numpy(), want_recs[t], atol=1e-5, err_msg=f"recurrent state {t}")
            np.testing.assert_allclose(prior_t.numpy(), want_priors[t], atol=1e-5, err_msg=f"prior logits {t}")


@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_torch_rssm_decoupled_step_metrics_match_jax(pairs, kind):
    check_metrics(pairs[kind])


@pytest.mark.parametrize("module", ["world_model", "critic", "target_critic"])
@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_torch_rssm_decoupled_step_updated_parameters_match_jax(pairs, kind, module):
    check_params(pairs[kind], module)


@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_torch_rssm_decoupled_step_actor_gradient_matches_jax(pairs, kind):
    check_actor_grads(pairs[kind])


@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_torch_rssm_decoupled_step_moments_match_jax(pairs, kind):
    for k in ("low", "high"):
        np.testing.assert_allclose(pairs[kind]["port"]["moments"][k], pairs[kind]["jax"]["moments"][k],
                                   rtol=1e-5, atol=1e-8)
