"""SAC-AE (pixel SAC with an autoencoder) in the port against the JAX
package, on the CPU, at a small size of the ``exp=sac_ae`` recipe on
``continuous_dummy`` (rgb 64x64x3, 2 actions): conv trunk 4 x 32 channels
(multiplier 1; the recipe's 16 gives 512), features 16, hidden 32, batch 4.

- the encoder (trunk, head, the actor's detached features through its own
  head) and the decoder from the same converted weights; the decoder's last
  transposed convolution pads its 64th row and column with ZEROS, as the
  JAX layer does, where ``nn.ConvTranspose2d(output_padding=1)`` would put
  the bias there;
- one train call of 2 gradient steps from ``cum0`` 1, so the first step
  skips the target EMAs and the actor (gates 2 and 2) and the second takes
  both, each takes the decoder's update (gate 1), on JAX's draws rebuilt
  from the call's key (``fold_in`` of the device index, ``split(key, G)``,
  per step ``k_next, k_actor, k_noise``): the losses, every parameter (the
  encoder moved by two optimizers), both EMAs (Qs at 0.01, encoder at 0.05);
  once with the recipe's Adams and once with each an SGD, which shows the
  gradients themselves;
- ``run preset=sac_ae`` (``exp=sac_ae``'s keys), checkpoint, resume and
  ``evaluation`` equal to the run's test episode.

Tolerances (float32 on both sides): encoder and decoder outputs within
1e-5; under SGD the four losses within rtol 1e-5 (atol 1e-6) and each
tensor's change within 1e-5 of JAX's relative to its norm; under Adam the
losses within rtol 1e-4 and every element within 1e-5 but for at most 0.5 %
of a module's, whose near-zero gradient may flip Adam's first step, held to
2 lr + 1e-5 (the test's docstrings say why).
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.sac_ae.utils import preprocess_obs as jax_preprocess_obs
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import LOSS_NAMES, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.sac_ae.utils import preprocess_obs
from sheeprl_tpu_torch.config import apply_overrides, dotdict, plain, preset
from sheeprl_tpu_torch.models import ConvTranspose
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import sac_ae_state_from_jax
from tests.test_torch_sac_loop import _leaves

BATCH, G, ACT = 4, 2, 2
SGD_LR, ADAM_LR = 1e-3, 1e-3  # ADAM_LR: the recipe's largest rate (critic, actor, encoder, decoder)
SMALL = ["algo.cnn_channels_multiplier=1", "algo.encoder.cnn_channels_multiplier=1",
         "algo.decoder.cnn_channels_multiplier=1", "algo.encoder.features_dim=16", "algo.hidden_size=32",
         "algo.actor.hidden_size=32", "algo.critic.hidden_size=32", f"algo.per_rank_batch_size={BATCH}"]
SPACES = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
          "actions": {"shape": [ACT], "low": [-1.0] * ACT, "high": [1.0] * ACT, "continuous": True}}
TINY = ["fabric.accelerator=cpu", "metric.log_level=0", "env.num_envs=2", "buffer.size=256",
        "algo.learning_starts=16", "checkpoint.every=0", "checkpoint.save_last=true", "buffer.memmap=false"] + SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def sides():
    cfg = compose(["exp=sac_ae", "env=dummy", "env.id=continuous_dummy"] + SMALL)
    fabric = Fabric(devices=1, accelerator="cpu")
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    act_space = gym.spaces.Box(-1.0, 1.0, (ACT,), np.float32)
    agent, params, _ = jax_build_agent(fabric, cfg, obs_space, act_space)
    params = jax.tree.map(np.asarray, params)
    port_cfg = dotdict({**plain(apply_overrides(preset("sac_ae"), SMALL)), "spaces": SPACES})
    port, _ = build_agent(port_cfg, "cpu", sac_ae_state_from_jax(params))
    return {"cfg": cfg, "fabric": fabric, "agent": agent, "params": params, "port_cfg": port_cfg, "port": port}


def _pixels(rng, lead):
    return rng.integers(0, 256, (*lead, 64, 64, 3)).astype(np.float32)


def test_torch_pixel_autoencoder_encoder_matches_jax(sides):
    agent, params, port = sides["agent"], sides["params"], sides["port"]
    obs = {"rgb": _pixels(np.random.default_rng(0), (BATCH,)) / 255.0}
    want = agent.critic_features(params["encoder"], obs)
    want_actor = agent.actor_features(params, obs)
    with torch.no_grad():
        got = port.encoder({"rgb": _t(obs["rgb"])})
        got_actor = port.actor_features({"rgb": _t(obs["rgb"])})
    assert got.shape == (BATCH, 16) and port.encoder.trunk_features == 25 * 25 * 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_actor.numpy(), np.asarray(want_actor), atol=1e-5)
    greedy = agent.greedy_action(params, obs)
    np.testing.assert_allclose(port.greedy_action({"rgb": _t(obs["rgb"])}).detach().numpy(), np.asarray(greedy),
                               atol=1e-5)


def test_torch_pixel_autoencoder_decoder_matches_jax_with_zero_padding(sides):
    agent, params, port = sides["agent"], sides["params"], sides["port"]
    latent = np.random.default_rng(1).normal(size=(BATCH, 16)).astype(np.float32)
    want = np.asarray(agent.decoder.apply(params["decoder"], jnp.asarray(latent))["rgb"])
    with torch.no_grad():
        got = port.decoder(_t(latent))["rgb"].numpy()
    assert got.shape == want.shape == (BATCH, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the padded last row and column are zeros on both sides
    assert not np.any(got[:, 63]) and not np.any(got[:, :, 63])
    assert not np.any(want[:, 63]) and not np.any(want[:, :, 63])


def test_torch_pixel_autoencoder_conv_transpose_pads_zeros_not_bias():
    layer = ConvTranspose(4, 3, 3, 2, output_padding=1)
    with torch.no_grad():
        layer.ConvTranspose_0.bias.fill_(0.5)
        out = layer(torch.randn(2, 4, 31, 31))
        torch_padded = torch.nn.functional.conv_transpose2d(torch.randn(2, 4, 31, 31), layer.ConvTranspose_0.weight,
                                                            layer.ConvTranspose_0.bias, stride=2, output_padding=1)
    assert out.shape == torch_padded.shape == (2, 3, 64, 64)
    assert torch.all(out[:, :, 63] == 0) and torch.all(out[:, :, :, 63] == 0)
    assert torch.all(torch_padded[:, :, 63, 63] == 0.5)  # what output_padding would have put there


def test_torch_pixel_autoencoder_preprocess_matches_jax():
    rng = np.random.default_rng(2)
    pixels = _pixels(rng, (3,))
    key = jax.random.PRNGKey(3)
    want = jax_preprocess_obs(jnp.asarray(pixels), bits=5, key=key)
    uniform = jax.random.uniform(key, pixels.shape, dtype=jnp.float32)
    got = preprocess_obs(_t(pixels), bits=5, uniform=_t(uniform))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


class _Sgd:
    """A port optimizer taking plain SGD steps at ``lr``, the twin of
    ``optax.sgd(lr)``."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    def step(self, grads):
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.sub_(self.lr * g)


@pytest.fixture(scope="module", params=["sgd", "adam"])
def train_call(sides, request):
    """One train call on both sides, with the recipe's five Adams, or with
    each of them an SGD at rate 1e-3, under which a parameter's change is its
    summed gradient and rounding noise cannot flip Adam's first step."""
    cfg, fabric, agent, params = sides["cfg"], sides["fabric"], sides["agent"], sides["params"]
    names = {"qf": "critic", "actor": "actor", "alpha": "alpha", "encoder": "encoder", "decoder": "decoder"}
    if request.param == "sgd":
        txs = {k: optax.sgd(SGD_LR) for k in names}
    else:
        txs = {k: jax_build_optimizer(cfg.algo[n].optimizer) for k, n in names.items()}
    jp = jax.tree.map(jnp.asarray, params)
    opts = {
        "qf": txs["qf"].init({"encoder": jp["encoder"], "qfs": jp["qfs"]}),
        "actor": txs["actor"].init({"actor": jp["actor"], "actor_enc_head": jp["actor_enc_head"]}),
        "alpha": txs["alpha"].init(jp["log_alpha"]),
        "encoder": txs["encoder"].init({"e": jp["encoder"]}),
        "decoder": txs["decoder"].init({"d": jp["decoder"]}),
    }
    train_fn = jax_make_train_step(agent, txs, cfg, fabric.mesh)
    rng = np.random.default_rng(4)
    data = {
        "rgb": _pixels(rng, (G, BATCH)),
        "next_rgb": _pixels(rng, (G, BATCH)),
        "actions": rng.uniform(-1, 1, (G, BATCH, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(G, BATCH, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(G, BATCH, 1)) < 0.25).astype(np.float32),
    }
    key = jax.random.PRNGKey(21)
    new, _, *losses = train_fn(jp, opts, {k: jnp.asarray(v) for k, v in data.items()}, key, jnp.int32(1))

    nxt, act, pix = [], [], []
    for k in jax.random.split(jax.random.fold_in(key, 0), G):
        k_next, k_actor, k_noise = jax.random.split(k, 3)
        nxt.append(np.asarray(jax.random.normal(k_next, (BATCH, ACT))))
        act.append(np.asarray(jax.random.normal(k_actor, (BATCH, ACT))))
        pix.append(np.asarray(jax.random.uniform(k_noise, (BATCH, 64, 64, 3), dtype=jnp.float32)))
    noise = {"next": _t(np.stack(nxt)), "actor": _t(np.stack(act)), "pixels": {"rgb": _t(np.stack(pix))}}
    port_cfg = sides["port_cfg"]
    port, _ = build_agent(port_cfg, "cpu", sac_ae_state_from_jax(params))
    optimizers = make_optimizers(port_cfg, port)
    if request.param == "sgd":
        optimizers = {k: _Sgd([p for group in opt.optimizer.param_groups for p in group["params"]], SGD_LR)
                      for k, opt in optimizers.items()}
    train = make_train_step(port, optimizers, port_cfg)
    got = train({k: _t(v) for k, v in data.items()}, 1, noise=noise)
    return {"kind": request.param,
            "jax": (sac_ae_state_from_jax(jax.tree.map(np.asarray, new)), [float(x) for x in losses]),
            "port": ({k: v.clone() for k, v in port.state_dict().items()}, got.tolist()),
            "before": sac_ae_state_from_jax(params)}


@pytest.mark.parametrize("index", range(len(LOSS_NAMES)), ids=[n.split("/")[1] for n in LOSS_NAMES])
def test_torch_pixel_autoencoder_train_call_losses_match_jax(train_call, index):
    got, want = train_call["port"][1][index], train_call["jax"][1][index]
    assert np.isfinite(got) and got != 0.0
    # under Adam, the second step's losses read parameters that the first
    # step's rounding noise may have moved by 2 lr (see below): rtol 1e-4
    rtol = 1e-5 if train_call["kind"] == "sgd" else 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6, err_msg=LOSS_NAMES[index])


@pytest.mark.parametrize("module", ["encoder", "actor_enc_head", "actor", "qfs", "target_encoder", "target_qfs",
                                    "decoder", "log_alpha"])
def test_torch_pixel_autoencoder_train_call_parameters_match_jax(train_call, module):
    """Under SGD each tensor's change (the summed gradient) within 1e-5 of
    JAX's relative to its norm, plus twice the float32 rounding of the
    stored values. Under Adam every element within 1e-5, except that an
    element whose gradient is within float32 noise of zero may take Adam's
    first step (about lr times the gradient's sign) the other way: at most
    0.5 % of a module's elements, each within 2 lr + 1e-5."""
    got, want, before = train_call["port"][0], train_call["jax"][0], train_call["before"]
    names = [k for k in want if k.split(".")[0] == module]
    assert names and set(names) == {k for k in got if k.split(".")[0] == module}
    moved, far, total = 0, 0, 0
    for name in names:
        g, w, b = got[name].numpy().astype(np.float64), want[name].numpy().astype(np.float64), before[name].numpy()
        moved += int(not np.array_equal(w, b))
        if train_call["kind"] == "sgd":
            # each stored float32 element also carries its own rounding: its ulp
            err, norm = np.linalg.norm(g - w), np.linalg.norm(w - b)
            rounding = float(np.linalg.norm(np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)))
            assert err <= 1e-5 * norm + 2 * rounding, f"{name}: change differs by {err} against {norm}"
        else:
            diff = np.abs(g - w)
            assert diff.max() <= 2 * ADAM_LR + 1e-5, name
            far += int(np.sum(diff > 1e-5))
            total += diff.size
    assert far <= total // 200, f"{module}: {far} of {total} elements differ by more than 1e-5"
    assert moved > 0


def test_torch_pixel_autoencoder_preset_is_the_jax_exp_sac_ae():
    port = preset("sac_ae")
    assert port.preset.composition == "exp=sac_ae"
    jax_cfg = compose(["exp=sac_ae"] + list(port.preset.overrides))
    checked = 0
    for path, value in _leaves(port):
        if path.startswith("preset."):
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        if path.endswith("_target_"):
            assert str(node).rsplit(".", 1)[-1] == value, path
        elif isinstance(value, float):
            assert float(node) == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 60 and port.algo.encoder.cnn_channels_multiplier * 32 == 512


def test_torch_pixel_autoencoder_loop_trains_resumes_and_evaluates(tmp_path):
    from sheeprl_tpu_torch.ops import kernels

    kernels.reset_launches()
    s = cli.run(["preset=sac_ae", f"log_root={tmp_path}", "algo.total_steps=40"] + TINY)
    assert s["device"] == "cpu" and s["gradient_steps"] > 0 and np.isfinite(np.asarray(s["losses"])).all()
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # a host-buffer path: no kernel
    saved = load_checkpoint(s["checkpoint"])
    assert set(saved["optimizers"]) == {"qf", "actor", "alpha", "encoder", "decoder"}
    assert {"rgb", "next_rgb"} <= set(saved["rb"]["buffer"])
    evaluated = cli.evaluation([f"checkpoint_path={s['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["reward"] == s["test_reward"] and evaluated["steps"] == s["test_steps"] == 129
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=48", "algo.learning_starts=4",
                       f"log_root={tmp_path}", "fabric.accelerator=cpu", "metric.log_level=0", "algo.run_test=false"])
    assert resumed["start_iter"] == 21 and resumed["gradient_steps"] > 0
