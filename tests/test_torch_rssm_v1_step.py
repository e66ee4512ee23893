"""Dreamer V1's gradient step in the port against the JAX package's
``make_train_step`` on the CPU, at a small pixel+vector size (2 layers of
width 32, recurrent state 32, stochastic state 8; batch 3 x sequence 4,
horizon 3), from weights carried across by ``dreamer_v1_state_from_jax``.

Two consecutive gradient steps, each on JAX's own draws (the keys' splits
rebuilt: ``fold_in`` of the device index, ``split(key, G)``; ``k_dyn,
k_img``; per dynamic step ``k_prior, k_post``, the posterior's normals from
``k_post``; per imagination step ``k_act, k_prior``), with the recipe's Adam
and gradient clipping, for two actors: discrete, and ``tanh_normal`` (the
continuous default of V1) with the continue head and no free nats, so that
the KL and the continue loss carry gradients. After each step: the ten
metrics within 1e-5 relative; every parameter of the world model, actor and
critic within 1e-6. The actor's loss reaches the actor through the imagined
RSSM steps (dynamics backpropagation); its backward leaves no gradient on
the world model, whose second step would otherwise differ, and no module
holds a ``.grad`` after a step.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import METRIC_NAMES, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import dreamer_v1_state_from_jax

T, B, H, N_ACT, REC, STOCH, WIDTH = 4, 3, 3, 3, 32, 8, 32
TINY = [
    "exp=dreamer_v1",
    "env=dummy",
    "env.num_envs=2",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={T}",
    f"algo.horizon={H}",
    f"algo.dense_units={WIDTH}",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={REC}",
    f"algo.world_model.representation_model.hidden_size={WIDTH}",
    f"algo.world_model.transition_model.hidden_size={WIDTH}",
    f"algo.world_model.stochastic_size={STOCH}",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "env.screen_size=64",
]
VARIANTS = {
    "discrete": (False, []),
    "tanh_normal": (True, ["algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0.0",
                           "algo.world_model.continue_scale_factor=0.5"]),
}
NAMES = ("world_model", "actor", "critic")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def configs(continuous: bool, extra=(), base=TINY):
    """The JAX config, the port's (the same keys and a ``spaces`` block) and
    the observation space."""
    cfg = compose(list(base) + list(extra))
    obs_space = gym.spaces.Dict(
        {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)}
    )
    actions = ({"shape": [N_ACT], "low": [-1.0] * N_ACT, "high": [1.0] * N_ACT, "continuous": True} if continuous
               else {"n": [N_ACT], "continuous": False})
    spaces = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}, "state": {"shape": [10], "dtype": "float32"}},
              "actions": actions}
    return cfg, dotdict({**jax_plain(cfg), "spaces": spaces}), obs_space


def batch(continuous: bool, seed: int):
    rng = np.random.default_rng(seed)
    actions = (rng.uniform(-1, 1, (1, T, B, N_ACT)).astype(np.float32) if continuous
               else np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))])
    data = {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3)).astype(np.float32),
        "state": rng.normal(size=(1, T, B, 10)).astype(np.float32),
        "actions": actions,
        "rewards": (rng.normal(size=(1, T, B, 1)) * 3).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
    }
    data["terminated"][:, 1, 0] = 1.0
    return data


def jax_imagination_noise(k_img, rows: int, continuous: bool):
    """V1's imagination draws: per step ``k_act, k_prior``; a discrete head's
    Gumbel uniforms from ``split(k_act, 1)[0]``, a ``tanh_normal`` action's
    normals from ``k_act``; the prior's normals from ``k_prior``."""
    priors, acts = [], []
    for k in jax.random.split(k_img, H):
        k_act, k_prior = jax.random.split(k)
        priors.append(np.asarray(jax.random.normal(k_prior, (rows, STOCH))))
        if continuous:
            acts.append(np.asarray(jax.random.normal(k_act, (rows, N_ACT))))
        else:
            acts.append(np.asarray(jax.random.uniform(jax.random.split(k_act, 1)[0], (rows, N_ACT),
                                                      minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
    return {"imagined_prior": _t(np.stack(priors)), "actions": [_t(np.stack(acts))]}


def jax_posterior_noise(k_dyn):
    return _t(np.stack([np.asarray(jax.random.normal(jax.random.split(k)[1], (B, STOCH)))
                        for k in jax.random.split(k_dyn, T)]))


def step_keys(key):
    """``k_dyn, k_img`` of gradient step 0 of a JAX call with ``key``."""
    key = jax.random.fold_in(key, 0)  # the device index on a one-device mesh
    return jax.random.split(jax.random.split(key, 1)[0])


def jax_noise(key, continuous: bool):
    k_dyn, k_img = step_keys(key)
    return {"posterior": jax_posterior_noise(k_dyn), **jax_imagination_noise(k_img, T * B, continuous)}


def _snapshot(modules):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()} for n, m in zip(NAMES, modules)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def steps(request):
    kind = request.param
    continuous, extra = VARIANTS[kind]
    cfg, port_cfg, obs_space = configs(continuous, extra)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), continuous, cfg, obs_space)
    before = dreamer_v1_state_from_jax(jax.tree.map(np.array, params))
    a = cfg.algo
    txs = {
        "world": jax_build_optimizer(a.world_model.optimizer, max_grad_norm=a.world_model.clip_gradients),
        "actor": jax_build_optimizer(a.actor.optimizer, max_grad_norm=a.actor.clip_gradients),
        "critic": jax_build_optimizer(a.critic.optimizer, max_grad_norm=a.critic.clip_gradients),
    }
    opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"])}
    train_fn = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACT,), continuous, txs)

    modules = build_agent(port_cfg, "cpu", before)
    train = make_train_step(*modules, make_optimizers(port_cfg, *modules), port_cfg)
    out = {"kind": kind, "before": before, "jax": [], "port": [], "grads_left": []}
    for i, key in enumerate((jax.random.PRNGKey(31), jax.random.PRNGKey(32))):
        data = batch(continuous, seed=i)
        params, opts, metrics = train_fn(params, opts, data, key)
        out["jax"].append({"metrics": [float(m) for m in metrics],
                           "params": dreamer_v1_state_from_jax(jax.tree.map(np.asarray, params))})
        port_metrics = train({k: torch.from_numpy(v) for k, v in data.items()}, noise=[jax_noise(key, continuous)])
        out["port"].append({"metrics": port_metrics[0].tolist(), "params": _snapshot(modules)})
        out["grads_left"].append([n for m in modules for n, p in m.named_parameters() if p.grad is not None])
    return out


@pytest.mark.parametrize("step", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[-1] for n in METRIC_NAMES])
def test_torch_rssm_v1_step_metric_matches_jax(steps, step, index):
    got, want = steps["port"][step]["metrics"][index], steps["jax"][step]["metrics"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{steps['kind']} {METRIC_NAMES[index]}")


@pytest.mark.parametrize("step", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("module", NAMES)
def test_torch_rssm_v1_step_parameters_match_jax(steps, step, module):
    got, want = steps["port"][step]["params"][module], steps["jax"][step]["params"][module]
    prev = steps["before"][module] if step == 0 else steps["jax"][0]["params"][module]
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{steps['kind']} step {step} {module}.{name}")
        moved += int(not np.array_equal(value.numpy(), prev[name].numpy()))
    assert moved > 0, f"step {step} left every {module} parameter where it was"


def test_torch_rssm_v1_step_leaves_no_gradient_behind(steps):
    """Every loss is differentiated with respect to its own module only:
    no parameter holds a ``.grad`` (the actor's backward through the
    imagined RSSM put none on the world model)."""
    assert steps["grads_left"] == [[], []]


def test_torch_rssm_v1_step_state_loss_holds_the_free_nats(steps):
    """At 3 free nats the state loss is the floor (its KL below it); at 0 it
    is the KL."""
    kl, state_loss = (steps["port"][0]["metrics"][METRIC_NAMES.index(n)] for n in ("State/kl", "Loss/state_loss"))
    if steps["kind"] == "discrete":
        assert state_loss == 3.0 and kl < 3.0
    else:
        assert state_loss == pytest.approx(kl)
