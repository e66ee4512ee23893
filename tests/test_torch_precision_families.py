"""The other families at ``fabric.precision=bf16-mixed``: their modules'
forwards on one batch against the JAX package's, on the CPU, from the same
float32 parameters (in the shapes JAX's ``build_agent`` gives, read with
``jax.eval_shape``: under ``bf16-mixed`` every one is float32, and the
``*_state_from_jax`` converters carry them unchanged).

- Dreamer V2 and V1 at the tiny sizes of their step tests: the encoder, the
  recurrent model over a bfloat16 carry and over the float32 carry a player
  starts from (V2's LayerNorm GRU through ``gru_gates_ln``, V1's flax-form
  GRU cell in plain ops), the representation and transition models, the
  decoders, the reward head, the actor and the critic;
- recurrent PPO at its recipe: the LSTM as flax's ``OptimizedLSTMCell``
  computes it in bfloat16 over a float32 carry, the actor's outputs, the
  values, the carried pair, and the log-prob and entropy of given actions
  (the PPO loss's terms);
- Plan2Explore's ensembles on DreamerV3 (stacked Dense and LayerNorm, the
  members side by side), on Dreamer V2 and V1 (no LayerNorm, ELU);
- SAC-AE at small widths: the encoder's convolutions, Dense and LayerNorm,
  the pixel decoder's transposed convolutions, the actor's head.

Bounds: each output in JAX's dtype (bfloat16 from a bf16 module, float32 over
a float32 carry or after a distribution's lift), and within 2e-2 of JAX's
relative to its mean magnitude (the mean absolute error). What each
comparison measured is in its assertion message.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel.fabric import Fabric
from tests.test_torch_precision_modules import flax_like_params

BF16 = torch.bfloat16
FABRIC = Fabric(devices=1, accelerator="cpu", precision="bf16-mixed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_shapes(build, index: int):
    """``build()``'s parameters (its output ``index``) as float32 draws
    (``flax_like_params``) and everything it returns, without compiling
    JAX's initialisation."""
    held = {}

    def params_only():
        held["out"] = build()
        return held["out"][index]

    params = flax_like_params(jax.eval_shape(params_only), seed=7, jitter=0.05)
    return held["out"], params


def jit(fn):
    """``fn`` under one ``jax.jit``: flax's eager dispatch compiles op by op,
    and the fusion's rounding sits far inside the bound."""
    return jax.jit(fn)


def check(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), f"{what}: port {got.dtype}, JAX {want.dtype}"
    g, w = got.detach().float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    err, scale = float(np.mean(np.abs(g - w))), float(np.mean(np.abs(w)))
    assert err <= 2e-2 * scale + 1e-6, f"{what}: mean error {err} against a mean magnitude {scale}"


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


def _obs(rng, n):
    return {"rgb": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.float32) / 255 - 0.5,
            "state": rng.normal(size=(n, 10)).astype(np.float32)}


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_torch_precision_families_rssm_modules_match_jax(version):
    if version == "v2":
        from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build
        from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
        from sheeprl_tpu_torch.utils.convert import dreamer_v2_state_from_jax as convert
        from tests.test_torch_rssm_v2_step import N_ACT, configs
    else:
        from sheeprl_tpu.algos.dreamer_v1.agent import build_agent as jax_build
        from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
        from sheeprl_tpu_torch.utils.convert import dreamer_v1_state_from_jax as convert
        from tests.test_torch_rssm_v1_step import N_ACT, configs
    cfg, port_cfg, obs_space = configs(False, ["fabric.precision=bf16-mixed"])
    (jwm, jactor, jcritic, _, _), params = jax_shapes(lambda: jax_build(FABRIC, (N_ACT,), False, cfg, obs_space), 3)
    modules = build_agent(port_cfg, "cpu", convert(params))
    wm, actor, critic = modules[:3]
    rssm = jwm.rssm
    rng = np.random.default_rng(3)
    rows = 4
    obs = _obs(rng, rows)
    rec_size = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    stoch = wm.stochastic_size if version == "v1" else int(cfg.algo.world_model.stochastic_size) * int(
        cfg.algo.world_model.discrete_size)
    x = rng.normal(size=(rows, stoch + N_ACT)).astype(np.float32)
    h = np.tanh(rng.normal(size=(rows, rec_size))).astype(np.float32)
    latent = rng.normal(size=(rows, stoch + rec_size)).astype(np.float32)
    with torch.no_grad():  # the representation model reads [h, the embedded observation]
        embed_width = int(wm.encoder({k: torch.from_numpy(v[:1]) for k, v in obs.items()}).shape[-1])
    rep_in = np.concatenate([h, rng.normal(size=(rows, embed_width)).astype(np.float32)], -1)

    @jit
    def jax_side(params, obs, x, h, latent, rep_in):
        wmp = params["world_model"]
        return {"encoder": jwm.encoder.apply(wmp["encoder"], obs),
                **{f"recurrent model over a {c} carry": rssm.recurrent_model.apply(
                    wmp["recurrent_model"], x.astype(jnp.bfloat16), h.astype(c)) for c in ("bfloat16", "float32")},
                "representation model": rssm.representation_model.apply(wmp["representation_model"],
                                                                        rep_in.astype(jnp.bfloat16)),
                "transition model": rssm.transition_model.apply(wmp["transition_model"], h.astype(jnp.bfloat16)),
                **{f"decoder {k}": v for k, v in jwm.decode(wmp, latent).items()},
                "reward": jwm.reward_model.apply(wmp["reward_model"], latent),
                "actor": jactor.apply(params["actor"], latent)[0], "critic": jcritic.apply(params["critic"], latent)}

    want = jax_side(params, obs, x, h, latent, rep_in)
    t = {k: torch.from_numpy(v) for k, v in (("x", x), ("h", h), ("latent", latent), ("rep_in", rep_in))}
    with torch.no_grad():
        got = {"encoder": wm.encoder({k: torch.from_numpy(v) for k, v in obs.items()}),
               "recurrent model over a bfloat16 carry": wm.recurrent_model(t["x"].to(BF16), t["h"].to(BF16)),
               "recurrent model over a float32 carry": wm.recurrent_model(t["x"].to(BF16), t["h"]),
               "representation model": wm.representation_model(t["rep_in"].to(BF16)),
               "transition model": wm.transition_model(t["h"].to(BF16)),
               **{f"decoder {k}": v for k, v in wm.decode(t["latent"]).items()},
               "reward": wm.reward_model(t["latent"]), "actor": actor(t["latent"])[0], "critic": critic(t["latent"])}
    assert set(got) == set(want)
    for what, w in want.items():
        check(got[what], w, what)


def test_torch_precision_families_recurrent_agent_matches_jax():
    from sheeprl_tpu.algos.ppo_recurrent.agent import RecurrentPPOAgent as JaxAgent
    from sheeprl_tpu.algos.ppo_recurrent.agent import forward_with_actions as jax_forward_with_actions
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, forward_with_actions
    from sheeprl_tpu_torch.config import apply_overrides, preset
    from sheeprl_tpu_torch.utils.convert import ppo_recurrent_state_from_jax

    cfg = apply_overrides(preset("ppo_recurrent"), ["fabric.precision=bf16-mixed"])
    H = int(cfg.algo.rnn.lstm.hidden_size)
    jax_agent = JaxAgent(actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
                         encoder_cfg=dict(cfg.algo.encoder), rnn_cfg=dict(cfg.algo.rnn),
                         actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic), dtype=jnp.bfloat16)
    z = jnp.zeros((1, H))
    params = flax_like_params(jax.eval_shape(jax_agent.init, jax.random.PRNGKey(0), {"state": jnp.zeros((1, 1, 4))},
                                             jnp.zeros((1, 1, 2)), z, z), seed=8, jitter=0.05)
    agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_recurrent_state_from_jax(params))
    rng = np.random.default_rng(9)
    T, B = 8, 3
    obs = {"state": rng.normal(size=(T, B, 4)).astype(np.float32)}
    prev = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]
    hx, cx = (rng.normal(size=(B, H)).astype(np.float32) * 0.5 for _ in range(2))
    actions = [np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]]
    args = ({"state": torch.from_numpy(obs["state"])}, torch.from_numpy(prev), torch.from_numpy(hx),
            torch.from_numpy(cx))
    with torch.no_grad():
        outs, values, (h, c) = agent(*args)
        logprob, entropy, _ = forward_with_actions(agent, *args, [torch.from_numpy(a) for a in actions])
    j_outs, j_values, (j_h, j_c) = jit(jax_agent.apply)(params, obs, prev, hx, cx)
    w_logprob, w_entropy, _ = jit(lambda *a: jax_forward_with_actions(jax_agent, *a))(params, obs, prev, hx, cx,
                                                                                     actions)
    for name, got, want in (("logits", outs[0], j_outs[0]), ("values", values, j_values), ("hx", h, j_h),
                            ("cx", c, j_c), ("log-prob", logprob, w_logprob), ("entropy", entropy, w_entropy)):
        check(got, want, name)


@pytest.mark.parametrize("version", ["explore_v3", "explore_v2", "explore_v1"])
def test_torch_precision_families_ensembles_match_jax(version):
    """The members' stacked forward on one batch of (latent, action) rows."""
    import importlib

    v = version[-1]
    jax_agent = importlib.import_module(f"sheeprl_tpu.algos.p2e_dv{v}.agent")
    port_agent = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_dv{v}.agent")
    convert = getattr(importlib.import_module("sheeprl_tpu_torch.utils.convert"), f"p2e_dv{v}_state_from_jax")
    if v == "3":
        from tests.test_torch_explore_step import N_ACT, TINY, configs
        cfg, port_cfg, obs_space = configs(False)
        cfg = compose(TINY + ["fabric.precision=bf16-mixed"])
        port_cfg["fabric"]["precision"] = "bf16-mixed"
        index = 5  # world model, ensembles, actor, critic, critics' spec, params, player
    else:
        step = importlib.import_module(f"tests.test_torch_explore_v{v}_step")
        N_ACT = step.N_ACT
        cfg, port_cfg, obs_space = (step.configs(False, ["fabric.precision=bf16-mixed"]) if v == "2" else
                                    step.configs(False, ["fabric.precision=bf16-mixed"], base=step.EXPLORE))
        index = 4  # world model, ensembles, actor, critic, params, player
    out, params = jax_shapes(lambda: jax_agent.build_agent(FABRIC, (N_ACT,), False, cfg, obs_space), index)
    agent = port_agent.build_agent(port_cfg, "cpu", convert(jax.tree.map(np.asarray, params)))
    width = agent.ensembles.model.dense_0.kernel.shape[1]
    x = np.random.default_rng(11).normal(size=(5, width)).astype(np.float32)
    with torch.no_grad():
        got = agent.ensembles(torch.from_numpy(x))
    apply = importlib.import_module("sheeprl_tpu.algos.p2e_dv3.agent").ensembles_apply
    check(got, jit(lambda p, x: apply(out[1], p, x))(params["ensembles"], jnp.asarray(x)), "ensembles")


def test_torch_precision_families_pixel_sac_modules_match_jax():
    from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.config import apply_overrides, dotdict, plain, preset
    from sheeprl_tpu_torch.utils.convert import sac_ae_state_from_jax
    from tests.test_torch_pixel_autoencoder import SMALL, SPACES

    over = SMALL + ["fabric.precision=bf16-mixed"]
    cfg = compose(["exp=sac_ae", "env=dummy", "env.id=continuous_dummy"] + over)
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    act_space = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)
    (jagent, _, _), params = jax_shapes(lambda: jax_build(FABRIC, cfg, obs_space, act_space), 1)
    port_cfg = dotdict({**plain(apply_overrides(preset("sac_ae"), over)), "spaces": SPACES})
    agent, _ = build_agent(port_cfg, "cpu", sac_ae_state_from_jax(jax.tree.map(np.asarray, params)))
    rgb = np.random.default_rng(12).integers(0, 255, (2, 64, 64, 3)).astype(np.float32) / 255 - 0.5
    with torch.no_grad():
        feat = agent.encoder({"rgb": torch.from_numpy(rgb)})
        actor_feat = agent.actor_features({"rgb": torch.from_numpy(rgb)})
        recon = agent.decoder(feat)
    want_feat = jit(jagent.critic_features)(params["encoder"], {"rgb": jnp.asarray(rgb)})
    check(feat, want_feat, "encoder")
    check(actor_feat, jit(jagent.actor_features)(params, {"rgb": jnp.asarray(rgb)}), "actor features")
    want_recon = jit(jagent.decoder.apply)(params["decoder"], want_feat)
    for k in want_recon:
        check(recon[k], want_recon[k], f"decoder {k}")
