"""The port's continuous DreamerV3 actor against the JAX package's, on the
CPU, at the tiny pixel+vector size of ``tests/test_torch_rssm_train.py``:
``TanhNormal``, the three continuous ``actor_dists`` (``scaled_normal``, what
``distribution.type=auto`` picks, ``normal`` and ``tanh_normal``),
``actor_sample`` with the action clip, and whole gradient steps of JAX's
``make_train_step`` (batch 2 x sequence 8, horizon 5) from converted weights,
on JAX's own draws: a continuous one, whose actor learns by dynamics
backpropagation through the imagined RSSM steps and the reward and critic
decodes, and a discrete one on the same world model, whose REINFORCE path
must be as before.

The actor's gradient is read exactly: both sides take the actor's step as
plain SGD with rate 1 (``optax.sgd(1.0)`` in JAX, a recorder in the port), so
JAX's gradient is the parameters' change. The world model and the critic
take their recipe Adams.

Noise: the step's key splits are rebuilt (``fold_in`` of the device index,
``split(key, G)``; ``k_dyn, k_img``; ``split(k_dyn, T)``, or with the
decoupled RSSM ``split(k_dyn)[0]`` for the one pass; ``k0, k_scan``; per
imagination step ``k_prior, k_act``). A discrete head draws Gumbel noise from
``uniform(key, minval=tiny)``; a continuous actor's ``Normal.rsample`` is
``mean + std * normal(key)``, so the port is fed ``jax.random.normal`` of
that key.

Tolerances (float32 both sides): distributions within 1e-6 (log-probs and
entropies within 1e-5, relative and absolute);
the ten metrics within rtol 1e-5, atol 1e-6; updated world-model, critic and
target-critic parameters within atol 1e-6 (an Adam step moves a parameter by
about its learning rate, 1e-4 or 8e-5); the actor's gradient within 1e-5 of
JAX's relative to its norm, per tensor; ``Moments`` within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu import distributions as JD
from sheeprl_tpu.algos.dreamer_v3.agent import Actor as JaxActor
from sheeprl_tpu.algos.dreamer_v3.agent import actor_dists as jax_actor_dists
from sheeprl_tpu.algos.dreamer_v3.agent import actor_sample as jax_actor_sample
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import distributions as TD
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, actor_dists, actor_sample, build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, draw_noise, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax, flax_to_state_dict
from tests.test_torch_rssm_train import tiny_configs

T, B, H = 8, 2, 5
N_ACT = 2  # the continuous action width, and the discrete head's size: one world model serves both
STEP = [f"algo.per_rank_batch_size={B}", f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}",
        "algo.hafner_initialization=False"]
CONTINUOUS_SPACE = {"shape": [N_ACT], "low": [-1.0] * N_ACT, "high": [1.0] * N_ACT, "continuous": True}
DISCRETE_SPACE = {"n": [N_ACT], "continuous": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def step_configs(extra=()):
    """The JAX config and the port's, with the flax default initialisation
    (no scale-0 heads, so the reward and critic decodes carry a gradient)."""
    cfg, port_cfg, obs_space = tiny_configs(STEP + list(extra))
    return cfg, jax_plain(cfg), obs_space


def _port_cfg(plain_cfg, continuous: bool):
    spaces = {
        "obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
        "actions": CONTINUOUS_SPACE if continuous else DISCRETE_SPACE,
    }
    return dotdict({**plain_cfg, "spaces": spaces})


def _jax_actor(cfg, continuous: bool, distribution: str = "auto") -> JaxActor:
    a = cfg.algo.actor
    dist = distribution if distribution != "auto" else ("scaled_normal" if continuous else "discrete")
    return JaxActor(actions_dim=(N_ACT,), is_continuous=continuous, distribution=dist,
                    dense_units=int(a.dense_units), mlp_layers=int(a.mlp_layers), init_std=float(a.init_std),
                    min_std=float(a.min_std), max_std=float(a.get("max_std", 1.0)), unimix=float(cfg.algo.unimix),
                    action_clip=float(a.action_clip))


def step_batch(continuous: bool):
    rng = np.random.default_rng(0)
    if continuous:
        actions = rng.uniform(-1, 1, (1, T, B, N_ACT)).astype(np.float32)
    else:
        actions = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))]
    data = {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3)).astype(np.float32),
        "state": rng.normal(size=(1, T, B, 10)).astype(np.float32),
        "actions": actions,
        "rewards": (rng.normal(size=(1, T, B, 1)) * 3).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["is_first"][:, 3, 0] = 1.0
    data["terminated"][:, 2, 0] = 1.0
    data["terminated"][:, 5, 1] = 1.0
    return data


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def jax_noise(key, stoch, discrete, continuous: bool, decoupled: bool):
    """The port's injected noise for gradient step 0 of a JAX call with
    ``key``, rebuilt from ``make_train_step``'s splits."""
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    k_dyn, k_img = jax.random.split(jax.random.split(key, 1)[0])
    if decoupled:
        k_repr, _ = jax.random.split(k_dyn)
        posterior = _uniform(k_repr, (T, B, stoch, discrete)).reshape(T, B, stoch * discrete)
    else:
        posterior = np.stack([_uniform(k, (B, stoch, discrete)).reshape(B, -1) for k in jax.random.split(k_dyn, T)])
    k0, k_scan = jax.random.split(k_img)
    priors, act_keys = [], [k0]
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        priors.append(_uniform(k_prior, (T * B, stoch, discrete)).reshape(T * B, -1))
        act_keys.append(k_act)
    if continuous:
        actions = [np.stack([np.asarray(jax.random.normal(k, (T * B, N_ACT))) for k in act_keys])]
    else:  # one head: its key is split(k, 1)[0]
        actions = [np.stack([_uniform(jax.random.split(k, 1)[0], (T * B, N_ACT)) for k in act_keys])]
    return {"posterior": _t(posterior), "imagined_prior": _t(np.stack(priors)), "actions": [_t(a) for a in actions]}


class _SgdRecorder:
    """The actor's optimizer in these tests: records the gradient and takes
    an SGD step at rate 1, as ``optax.sgd(1.0)`` does on the JAX side."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.sub_(g)


def build_jax(extra=()):
    """One JAX build (continuous actor) and the configs; the discrete actor
    is built on the same world model by hand."""
    cfg, plain_cfg, obs_space = step_configs(extra)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), True, cfg, obs_space)
    return {"cfg": cfg, "plain": plain_cfg, "fabric": fabric, "world_model": world_model, "critic": critic,
            "params": jax.tree.map(np.asarray, params)}


def step_pair(built, continuous: bool, seed: int = 11):
    """One JAX gradient step and the port's on its draws, from the same
    converted weights; returns both sides' metrics, updated parameters,
    ``Moments`` and actor gradient."""
    cfg, fabric = built["cfg"], built["fabric"]
    params = dict(built["params"])
    actor = _jax_actor(cfg, continuous)
    if not continuous:
        latent = int(cfg.algo.world_model.stochastic_size) * int(cfg.algo.world_model.discrete_size) + int(
            cfg.algo.world_model.recurrent_model.recurrent_state_size)
        params["actor"] = jax.tree.map(np.asarray, actor.init(jax.random.PRNGKey(3), jnp.zeros((1, latent))))
    before = jax.tree.map(np.array, params)
    txs = {
        "world": jax_build_optimizer(cfg.algo.world_model.optimizer, max_grad_norm=cfg.algo.world_model.clip_gradients),
        "actor": optax.sgd(1.0),
        "critic": jax_build_optimizer(cfg.algo.critic.optimizer, max_grad_norm=cfg.algo.critic.clip_gradients),
    }
    jparams = jax.tree.map(jnp.asarray, params)
    opts = {"world": txs["world"].init(jparams["world_model"]), "actor": txs["actor"].init(jparams["actor"]),
            "critic": txs["critic"].init(jparams["critic"])}
    train_fn = jax_make_train_step(built["world_model"], actor, built["critic"], cfg, fabric.mesh, (N_ACT,), continuous,
                                   txs)
    data = step_batch(continuous)
    key = jax.random.PRNGKey(seed)
    jparams, opts, jax_moments, metrics = train_fn(jparams, opts, jax_init_moments(), data, key, jnp.int32(0))
    after = jax.tree.map(np.asarray, jparams)

    port_cfg = _port_cfg(built["plain"], continuous)
    wm, port_actor, port_critic, port_target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(before))
    optimizers = make_optimizers(port_cfg, wm, port_actor, port_critic)
    optimizers["actor"] = _SgdRecorder(port_actor.parameters())
    port_train = make_train_step(wm, port_actor, port_critic, port_target, optimizers, port_cfg)
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    noise = jax_noise(key, S, D, continuous, bool(cfg.algo.world_model.decoupled_rssm))
    port_moments, port_metrics, _ = port_train({k: torch.from_numpy(v) for k, v in data.items()}, init_moments(), 0,
                                               noise=[noise])
    jax_state = dreamer_v3_state_from_jax(after)
    before_actor = flax_to_state_dict(before["actor"])
    names = [n for n, _ in port_actor.named_parameters()]
    return {
        "jax": {"metrics": [float(m) for m in metrics], "moments": {k: float(v) for k, v in jax_moments.items()},
                "params": jax_state,
                "actor_grads": {n: (before_actor[n] - jax_state["actor"][n]).numpy() for n in names}},
        "port": {"metrics": port_metrics[0].tolist(), "moments": {k: float(v) for k, v in port_moments.items()},
                 "params": {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in
                            (("world_model", wm), ("critic", port_critic), ("target_critic", port_target))},
                 "actor_grads": dict(zip(names, (g.numpy() for g in optimizers["actor"].grads)))},
        "before": dreamer_v3_state_from_jax(before),
    }


def check_metrics(pair):
    got, want = np.asarray(pair["port"]["metrics"]), np.asarray(pair["jax"]["metrics"])
    assert np.isfinite(got).all()
    for i, name in enumerate(METRIC_NAMES):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6, err_msg=name)


def check_params(pair, module):
    got, want = pair["port"]["params"][module], pair["jax"]["params"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=f"{module}.{name}")
        moved += int(not np.array_equal(value.numpy(), pair["before"][module][name].numpy()))
    if module != "target_critic":  # the first step copies the critic into the target: unchanged there
        assert moved > 0


def check_actor_grads(pair):
    got, want = pair["port"]["actor_grads"], pair["jax"]["actor_grads"]
    assert set(got) == set(want)
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    assert total > 0
    for name, w in want.items():
        scale = max(float(np.linalg.norm(w)), 1e-12)
        err = float(np.linalg.norm(got[name].astype(np.float64) - w))
        assert err <= 1e-5 * scale + 1e-9, f"actor.{name}: gradient error {err} against norm {scale}"


@pytest.fixture(scope="module")
def built():
    return build_jax()


@pytest.fixture(scope="module")
def continuous_pair(built):
    return step_pair(built, continuous=True)


@pytest.fixture(scope="module")
def discrete_pair(built):
    return step_pair(built, continuous=False)


# -- distributions and sampling ------------------------------------------------------


def test_torch_rssm_continuous_tanh_normal_matches_jax():
    rng = np.random.default_rng(0)
    loc, scale = rng.normal(size=(6, 3)).astype(np.float32), rng.uniform(0.2, 2.0, (6, 3)).astype(np.float32)
    value = rng.uniform(-0.99, 0.99, (6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want_dist, got_dist = JD.TanhNormal(jnp.asarray(loc), jnp.asarray(scale)), TD.TanhNormal(_t(loc), _t(scale))
    np.testing.assert_allclose(got_dist.log_prob(_t(value)).numpy(), np.asarray(want_dist.log_prob(value)), atol=1e-5)
    np.testing.assert_allclose(got_dist.mode.numpy(), np.asarray(want_dist.mode), atol=1e-6)
    np.testing.assert_allclose(got_dist.mean.numpy(), np.asarray(want_dist.mean), atol=1e-6)
    noise = _t(jax.random.normal(key, (6, 3)))
    np.testing.assert_allclose(got_dist.rsample(noise=noise).numpy(), np.asarray(want_dist.rsample(key)), atol=1e-6)
    # the clipped edges: a value of +-1 is clamped inside the support on both sides
    edge = np.array([[1.0, -1.0, 0.0]] * 6, np.float32)
    np.testing.assert_allclose(got_dist.log_prob(_t(edge)).numpy(), np.asarray(want_dist.log_prob(edge)), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        want_dist.entropy()
    with pytest.raises(NotImplementedError):
        got_dist.entropy()
    with pytest.raises(NotImplementedError):
        TD.Independent(got_dist, 1).entropy()


@pytest.mark.parametrize("distribution", ["auto", "scaled_normal", "normal", "tanh_normal"])
def test_torch_rssm_continuous_actor_dists_match_jax(distribution):
    cfg, _, _ = step_configs()
    actor = _jax_actor(cfg, True, distribution)
    latent = 4 * 4 + 16
    params = actor.init(jax.random.PRNGKey(1), jnp.zeros((1, latent)))
    port = Actor(latent, (N_ACT,), int(cfg.algo.actor.dense_units), int(cfg.algo.actor.mlp_layers),
                 float(cfg.algo.unimix), is_continuous=True, distribution=distribution)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    assert port.distribution == ("scaled_normal" if distribution == "auto" else distribution)
    x = np.random.default_rng(2).normal(size=(5, latent)).astype(np.float32) * 3
    want = jax_actor_dists(actor, actor.apply(params, x))[0]
    with torch.no_grad():
        got = actor_dists(port, port(_t(x)))[0]
    value = np.random.default_rng(3).uniform(-0.9, 0.9, (5, N_ACT)).astype(np.float32)
    np.testing.assert_allclose(got.mode.numpy(), np.asarray(want.mode), atol=1e-6)
    # the ``normal`` head's std is the raw output: a negative one gives NaN on both sides
    np.testing.assert_allclose(got.log_prob(_t(value)).numpy(), np.asarray(want.log_prob(value)), rtol=1e-5,
                               atol=1e-5)
    if distribution == "tanh_normal":
        with pytest.raises(NotImplementedError):
            got.entropy()
    else:
        np.testing.assert_allclose(got.entropy().numpy(), np.asarray(want.entropy()), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("distribution", ["scaled_normal", "normal", "tanh_normal"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_torch_rssm_continuous_actor_sample_with_clip_matches_jax(distribution, greedy):
    cfg, _, _ = step_configs()
    actor = _jax_actor(cfg, True, distribution)
    latent = 4 * 4 + 16
    params = actor.init(jax.random.PRNGKey(1), jnp.zeros((1, latent)))
    port = Actor(latent, (N_ACT,), int(cfg.algo.actor.dense_units), int(cfg.algo.actor.mlp_layers),
                 float(cfg.algo.unimix), is_continuous=True, distribution=distribution)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    x = np.random.default_rng(5).normal(size=(64, latent)).astype(np.float32) * 4
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_actor_sample(actor, params, jnp.asarray(x), key, greedy=greedy)[0][0])
    noise = None if greedy else [_t(jax.random.normal(key, (64, N_ACT)))]
    got = actor_sample(port, _t(x), noise, greedy)[0][0].detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got).max() <= 1.0 + 1e-6  # the clip
    if distribution == "normal" and not greedy:
        assert np.abs(got).max() > 0.999, "no draw reached the clip"


def test_torch_rssm_continuous_actor_sample_rejects_missing_noise():
    cfg, _, _ = step_configs()
    port = Actor(32, (N_ACT,), 8, 1, 0.01, is_continuous=True)
    with pytest.raises(ValueError, match="noise"):
        actor_sample(port, torch.zeros(3, 32))
    with pytest.raises(ValueError, match="distribution.type"):
        Actor(32, (N_ACT,), 8, 1, 0.01, is_continuous=True, distribution="discrete")


def test_torch_rssm_continuous_draw_noise_gives_normals_for_a_continuous_actor():
    _, plain_cfg, _ = step_configs()
    cfg = _port_cfg(plain_cfg, True)
    gen = torch.Generator().manual_seed(0)
    noise = draw_noise(cfg, T, B, [N_ACT], gen, "cpu", continuous=True)
    assert len(noise["actions"]) == 1 and noise["actions"][0].shape == (H + 1, T * B, N_ACT)
    assert float(noise["actions"][0].min()) < 0.0  # normals, not uniforms
    discrete = draw_noise(cfg, T, B, [N_ACT], torch.Generator().manual_seed(0), "cpu")
    assert float(discrete["actions"][0].min()) > 0.0


# -- the gradient step ---------------------------------------------------------------


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[1] for n in METRIC_NAMES])
def test_torch_rssm_continuous_step_metric_matches_jax(continuous_pair, index):
    got, want = continuous_pair["port"]["metrics"][index], continuous_pair["jax"]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=METRIC_NAMES[index])


@pytest.mark.parametrize("module", ["world_model", "critic", "target_critic"])
def test_torch_rssm_continuous_step_updated_parameters_match_jax(continuous_pair, module):
    check_params(continuous_pair, module)


def test_torch_rssm_continuous_step_actor_gradient_matches_jax(continuous_pair):
    """The dynamics-backpropagation gradient: it reaches every actor
    parameter (the MLP and both halves of ``head_0``) through the imagined
    steps, and equals JAX's."""
    check_actor_grads(continuous_pair)
    head = continuous_pair["port"]["actor_grads"]["head_0.weight"]
    assert np.abs(head[:N_ACT]).sum() > 0 and np.abs(head[N_ACT:]).sum() > 0


def test_torch_rssm_continuous_step_moments_match_jax(continuous_pair):
    for k in ("low", "high"):
        np.testing.assert_allclose(continuous_pair["port"]["moments"][k], continuous_pair["jax"]["moments"][k],
                                   rtol=1e-5, atol=1e-8)


def test_torch_rssm_continuous_discrete_step_still_matches_jax(discrete_pair):
    """The discrete actor's REINFORCE step on the same world model: metrics,
    updated parameters and the actor's gradient as JAX's."""
    check_metrics(discrete_pair)
    for module in ("world_model", "critic", "target_critic"):
        check_params(discrete_pair, module)
    check_actor_grads(discrete_pair)
