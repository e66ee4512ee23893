"""The port's DreamerV3 training modules against the JAX package's, on the
CPU, under weights carried across by ``dreamer_v3_state_from_jax``, at the
tiny pixel+vector size of ``tests/test_algos/test_dreamer_scan.py``.

Tolerances, all float32: module outputs within atol 1e-5 (flax's one-pass
LayerNorm variance against torch's two-pass one, matmuls summed in another
order); sampled one-hot states the same draws (equal once rounded: the
straight-through ``hard + p - p`` leaves an ulp), from the uniforms JAX's keys
give (``jax.random.categorical`` is Gumbel-argmax over
``uniform(key, minval=tiny, maxval=1)``); losses and returns within rtol
1e-5.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.algos.dreamer_v3 import loss as jax_loss
from sheeprl_tpu.algos.dreamer_v3 import utils as jax_utils
from sheeprl_tpu.algos.dreamer_v3.agent import CNNDecoder as JaxCNNDecoder
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.algos.dreamer_v3 import loss as torch_loss
from sheeprl_tpu_torch.algos.dreamer_v3 import utils as torch_utils
from sheeprl_tpu_torch.algos.dreamer_v3.agent import CNNDecoder, build_agent, build_training_agent
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax, flax_to_state_dict

N_ACTIONS = 3
TINY = [
    "exp=dreamer_v3",
    "algo=dreamer_v3_XS",
    "env=dummy",
    "env.num_envs=2",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=4",
    "algo.horizon=3",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.reward_model.bins=17",
    "algo.critic.bins=17",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.screen_size=64",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_configs(extra=()):
    """The JAX config and the port's (the same keys plus a ``spaces`` block)."""
    cfg = compose(TINY + list(extra))
    obs_space = gym.spaces.Dict(
        {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)}
    )
    spaces = {
        "obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
        "actions": {"n": [N_ACTIONS], "continuous": False},
    }
    return cfg, dotdict({**jax_plain(cfg), "spaces": spaces}), obs_space


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg, obs_space = tiny_configs()
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    numpy_params = jax.tree.map(np.asarray, params)
    port = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(numpy_params))
    return {"jax": (world_model, actor, critic, params), "port": port, "cfg": port_cfg}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def _same_draw(got, want):
    """The same one-hot draw: the straight-through ``hard + p - p`` of each
    framework rounds to the hard one-hot within an ulp."""
    np.testing.assert_array_equal(np.round(got.numpy()), np.round(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_torch_rssm_train_whole_state_carries_over(agents):
    """``build_training_agent`` loads the converted tree strictly: every
    world-model, actor and critic key of the JAX tree has its place."""
    wm, actor, critic, target = agents["port"]
    _, _, _, params = agents["jax"]
    for name in ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model"):
        assert getattr(wm, name) is not None
    for a, b in zip(critic.state_dict().values(), target.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(p.requires_grad for p in target.parameters())


def test_torch_rssm_train_own_init_follows_the_jax_output_scales():
    """From a seed, without JAX weights: the reward head's and the critic's
    output layers are zeros (scale 0.0), the continue head's and decoders'
    are not, and the target critic is a copy of the critic."""
    _, port_cfg, _ = tiny_configs()
    wm, actor, critic, target = build_training_agent(port_cfg, "cpu")
    assert torch.count_nonzero(wm.reward_model.out.weight) == 0
    assert torch.count_nonzero(critic.out.weight) == 0
    assert torch.count_nonzero(wm.continue_model.out.weight) > 0
    assert torch.count_nonzero(wm.cnn_decoder.out.ConvTranspose_0.weight) > 0
    for a, b in zip(critic.parameters(), target.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the serving subset draws the same weights whether or not training heads exist
    serve_wm, serve_actor = build_agent(port_cfg, "cpu")
    for k, v in serve_wm.state_dict().items():
        torch.testing.assert_close(v, wm.state_dict()[k], rtol=0, atol=0)


def test_torch_rssm_train_decoders_and_heads_match_jax(agents):
    world_model, actor, critic, params = agents["jax"]
    wm, _, port_critic, _ = agents["port"]
    wmp = params["world_model"]
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(3, 2, 32)).astype(np.float32)
    want = world_model.decode(wmp, jnp.asarray(latent))
    with torch.no_grad():
        got = wm.decode(_t(latent))
        assert got["rgb"].shape == (3, 2, 64, 64, 3) and got["state"].shape == (3, 2, 10)
        for k in ("rgb", "state"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)
        for name, port_head, jax_head, p in (
            ("reward", wm.reward_model, world_model.reward_model, wmp["reward_model"]),
            ("continue", wm.continue_model, world_model.continue_model, wmp["continue_model"]),
            ("critic", port_critic, critic, params["critic"]),
        ):
            np.testing.assert_allclose(
                port_head(_t(latent)).numpy(), np.asarray(jax_head.apply(p, jnp.asarray(latent))), atol=1e-5,
                err_msg=name,
            )


def test_torch_rssm_train_cnn_decoder_needs_the_transposed_layout():
    """The CNN decoder alone at 64x64 under converted weights: the
    ConvTranspose mapping (flipped, (in, out, kh, kw)) matches flax; the
    Conv2d mapping the converter used to apply to every rank-4 kernel does
    not."""
    rng = np.random.default_rng(1)
    latent = rng.normal(size=(2, 20)).astype(np.float32)
    jd = JaxCNNDecoder(keys=("rgb",), output_channels=(3,), channels_multiplier=2, cnn_encoder_output_dim=256)
    params = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(3), jnp.asarray(latent)))
    params = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)  # non-zero biases
    want = np.asarray(jd.apply(params, jnp.asarray(latent))["rgb"])
    td = CNNDecoder(("rgb",), (3,), 2, 20, 256, stages=4)
    td.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = td(_t(latent))["rgb"].numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)

    # the Conv2d mapping gives (out, in, kh, kw): the decoder refuses it
    old = flax_to_state_dict(params)
    for path in ("deconv_0", "deconv_1", "deconv_2", "out"):
        kernel = params["params"][path]["ConvTranspose_0"]["kernel"]
        old[f"{path}.ConvTranspose_0.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    with pytest.raises(RuntimeError, match="size mismatch"):
        td.load_state_dict(old)


def test_torch_rssm_train_conv_transpose_with_square_channels():
    """Where in == out channels the Conv2d mapping loads without complaint
    and gives a wrong result; the ConvTranspose mapping matches flax."""
    from sheeprl_tpu.models.blocks import _ConvTranspose
    from sheeprl_tpu_torch.models import ConvTranspose

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jc = _ConvTranspose(features=4, kernel_size=(4, 4), strides=(2, 2), padding=1)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    tc = ConvTranspose(4, 4, 4, 2, padding=1)
    kernel = params["params"]["ConvTranspose_0"]["kernel"]
    results = {}
    for name, weight in (
        ("transposed", flax_to_state_dict(params)["ConvTranspose_0.weight"]),
        ("conv2d", torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))),
    ):
        tc.load_state_dict({"ConvTranspose_0.weight": weight, "ConvTranspose_0.bias": _t(params["params"]["ConvTranspose_0"]["bias"])})
        with torch.no_grad():
            results[name] = tc(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert results["transposed"].shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(results["transposed"], want, atol=1e-5)
    assert np.abs(results["conv2d"] - want).max() > 1e-2


def test_torch_rssm_train_dynamic_and_imagination_match_jax(agents):
    """Two dynamic steps (the second with an is_first reset on row 1) and one
    imagination step, the draws fed from JAX's keys."""
    world_model, _, _, params = agents["jax"]
    wm = agents["port"][0]
    wmp = params["world_model"]
    rssm = world_model.rssm
    rng = np.random.default_rng(2)
    B = 3
    emb = rng.normal(size=(2, B, 256 + 8)).astype(np.float32)  # CNN and MLP encoder widths
    act = np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, (2, B))]
    first = np.zeros((2, B, 1), np.float32)
    first[1, 1] = 1.0
    rec = np.tanh(rng.normal(size=(B, 16))).astype(np.float32)
    post = np.asarray(jax.nn.one_hot(rng.integers(0, 4, (B, 4)), 4)).reshape(B, 16).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    j_rec, j_post, t_rec, t_post = jnp.asarray(rec), jnp.asarray(post), _t(rec), _t(post)
    with torch.no_grad():
        for t in range(2):
            j_rec, j_post, j_pl, j_prl = rssm.dynamic(
                wmp, j_post, j_rec, jnp.asarray(act[t]), jnp.asarray(emb[t]), jnp.asarray(first[t]), keys[t]
            )
            t_rec, t_post, t_pl, t_prl = wm.dynamic(
                t_post, t_rec, _t(act[t]), _t(emb[t]), _t(first[t]), _t(_uniform(keys[t], (B, 4, 4))).reshape(B, 16)
            )
            np.testing.assert_allclose(t_rec.numpy(), np.asarray(j_rec), atol=1e-5, err_msg=f"step {t}")
            np.testing.assert_allclose(t_pl.numpy(), np.asarray(j_pl), atol=1e-5)
            np.testing.assert_allclose(t_prl.numpy(), np.asarray(j_prl), atol=1e-5)
            _same_draw(t_post, j_post)
            t_post = _t(j_post)  # teacher-force the state row
        j_prior, j_rec2 = rssm.imagination(wmp, j_post, j_rec, jnp.asarray(act[0]), keys[2])
        t_prior, t_rec2 = wm.imagination(t_post, t_rec, _t(act[0]), _t(_uniform(keys[2], (B, 4, 4))).reshape(B, 16))
    np.testing.assert_allclose(t_rec2.numpy(), np.asarray(j_rec2), atol=1e-5)
    _same_draw(t_prior, j_prior)


def test_torch_rssm_train_distributions_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 4, 17)).astype(np.float32) * 2
    value = (rng.normal(size=(5, 4, 1)) * 20).astype(np.float32)
    j2, t2 = JD.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1), TD.TwoHotEncodingDistribution(_t(logits))
    np.testing.assert_allclose(t2.mean.numpy(), np.asarray(j2.mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2.log_prob(_t(value)).numpy(), np.asarray(j2.log_prob(jnp.asarray(value))), rtol=1e-5, atol=1e-5)

    mode = rng.normal(size=(5, 4, 6)).astype(np.float32)
    target = (rng.normal(size=(5, 4, 6)) * 3).astype(np.float32)
    for jcls, tcls in ((JD.SymlogDistribution, TD.SymlogDistribution), (JD.MSEDistribution, TD.MSEDistribution)):
        jd, td = jcls(jnp.asarray(mode), dims=1), tcls(_t(mode), dims=1)
        np.testing.assert_allclose(td.log_prob(_t(target)).numpy(), np.asarray(jd.log_prob(jnp.asarray(target))), rtol=1e-5)
        np.testing.assert_allclose(td.mode.numpy(), np.asarray(jd.mode), rtol=1e-5)

    cont = rng.normal(size=(5, 4, 1)).astype(np.float32) * 3
    cont[0, 0, 0] = 0.0  # p == 0.5: the safe mode is 0
    labels = rng.integers(0, 2, size=(5, 4, 1)).astype(np.float32)
    jb, tb = JD.Independent(JD.BernoulliSafeMode(jnp.asarray(cont)), 1), TD.Independent(TD.BernoulliSafeMode(_t(cont)), 1)
    np.testing.assert_allclose(tb.log_prob(_t(labels)).numpy(), np.asarray(jb.log_prob(jnp.asarray(labels))), rtol=1e-5)
    np.testing.assert_array_equal(tb.mode.numpy(), np.asarray(jb.mode))
    np.testing.assert_allclose(tb.entropy().numpy(), np.asarray(jb.entropy()), rtol=1e-5)

    p = rng.normal(size=(5, 4, 8)).astype(np.float32)
    q = rng.normal(size=(5, 4, 8)).astype(np.float32)
    jk = JD.kl_divergence(JD.Independent(JD.OneHotCategorical(jnp.asarray(p)), 1), JD.Independent(JD.OneHotCategorical(jnp.asarray(q)), 1))
    tk = TD.kl_divergence(TD.Independent(TD.OneHotCategorical(_t(p)), 1), TD.Independent(TD.OneHotCategorical(_t(q)), 1))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)


def test_torch_rssm_train_reconstruction_loss_matches_jax():
    rng = np.random.default_rng(4)
    T, B, S, D = 4, 3, 4, 4
    obs = {"rgb": rng.normal(size=(T, B, 8, 8, 3)).astype(np.float32), "state": rng.normal(size=(T, B, 5)).astype(np.float32)}
    recon = {k: (v + rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in obs.items()}
    reward_logits = rng.normal(size=(T, B, 17)).astype(np.float32)
    rewards = rng.normal(size=(T, B, 1)).astype(np.float32)
    prior = rng.normal(size=(T, B, S, D)).astype(np.float32)
    post = rng.normal(size=(T, B, S, D)).astype(np.float32) * 3
    cont = rng.normal(size=(T, B, 1)).astype(np.float32)
    targets = rng.integers(0, 2, size=(T, B, 1)).astype(np.float32)

    def run(D_, loss_mod, arr):
        po = {"rgb": D_.MSEDistribution(arr(recon["rgb"]), dims=3), "state": D_.SymlogDistribution(arr(recon["state"]), dims=1)}
        return loss_mod.reconstruction_loss(
            po, {k: arr(v) for k, v in obs.items()}, D_.TwoHotEncodingDistribution(arr(reward_logits)),
            arr(rewards), arr(prior), arr(post), 0.5, 0.1, 1.0, 1.0,
            D_.Independent(D_.BernoulliSafeMode(arr(cont)), 1), arr(targets), 1.0,
        )

    want = run(JD, jax_loss, jnp.asarray)
    got = run(TD, torch_loss, _t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_torch_rssm_train_lambda_values_and_moments_match_jax():
    rng = np.random.default_rng(5)
    H, N = 6, 7
    rewards = rng.normal(size=(H, N, 1)).astype(np.float32)
    values = rng.normal(size=(H, N, 1)).astype(np.float32) * 3
    continues = (rng.uniform(size=(H, N, 1)) > 0.2).astype(np.float32) * 0.997
    want = jax_utils.compute_lambda_values(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(continues), 0.95)
    got = torch_utils.compute_lambda_values(_t(rewards), _t(values), _t(continues), 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    j_state, t_state = jax_utils.init_moments(), torch_utils.init_moments()
    for i in range(3):
        x = (rng.normal(size=(H, N, 1)) * (i + 1)).astype(np.float32)
        j_state, j_off, j_inv = jax_utils.moments_update(j_state, jnp.asarray(x), 0.99, 1.0, 0.05, 0.95)
        t_state, t_off, t_inv = torch_utils.moments_update(t_state, _t(x), 0.99, 1.0, 0.05, 0.95)
        for a, b in ((t_off, j_off), (t_inv, j_inv), (t_state["low"], j_state["low"]), (t_state["high"], j_state["high"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
        assert t_state["low"].dtype == torch.float32 and t_state["low"].shape == ()
