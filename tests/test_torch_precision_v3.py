"""The port's DreamerV3 at ``fabric.precision=bf16-mixed`` against the JAX
package's on the CPU: one whole gradient step of the continuous actor at the
tiny pixel+vector size of ``tests/test_torch_rssm_continuous.py`` (batch 2 x
sequence 8, horizon 5), from the same float32 parameters (flax's default
draw, in the shapes JAX's ``build_agent`` gives) and on JAX's own draws, with
JAX's kernels on the Pallas tier in interpret mode (what the TPU runs).

Every optimizer is a recorder that keeps the gradient and leaves the
parameters as they are, on both sides (in JAX a ``GradientTransformation``
that returns zero updates and keeps the gradient as its state), so each
gradient is read exactly and every loss is taken at the same parameters.

Bounds: the ten metrics within 2e-2 relative (1e-3 absolute). The actor's
and the critic's gradients (each as one vector) have cosine similarity at
least 0.999 to JAX's. The world model's has a distance ``1 - cos`` to JAX's at
most ``max(1e-3, 2 d_jax)``, where ``d_jax`` is JAX's bfloat16 gradient's
distance from the float32 gradient of the same step (the port's, which holds
JAX's float32 gradient within 1e-5: the float32 parity tests). The port's own
distance does not enter the bound: two independent bfloat16 roundings of one
float32 gradient lie ``d_port + d_jax`` apart, so the bound admits the port's
bfloat16 noise up to JAX's own and no further. The world model needs that form
at this size: XLA's CPU backend sums a bfloat16 bias's gradient over the rows
in bfloat16 (65,536 terms of 0.01 sum to 16), where torch and the TPU
accumulate in float32, which puts JAX's world-model gradient 0.018 from float32
here (measured: port to JAX 0.0182, JAX to float32 0.0183, port to float32
0.0002; actor 1.0e-4, critic 1.2e-5 to JAX). Every module's bfloat16 gradient
also differs from its float32 one, so a step that ran in float32 fails. The
parameters stay float32. What each comparison measured is in its assertion
message.

Planted faults: a step computing in float32 fails the last check; a bf16
LayerNorm whose backward drops the mean's term reads the world model at
cosine 0.396 to JAX's against a bound of 0.963. A float32 backward under the
bf16 forward passes: its gradient lies inside JAX's own bfloat16 noise, which
a cosine bound at that noise cannot tell apart.

A categorical draw whose two best classes lie within bfloat16 rounding of a
tie can go either way on either side; one such flip moves this step's
losses by up to 15 %. The parameters (flax's default pattern from seed 0),
the batch and the key (those of the float32 parity test) give none, and the
port's bfloat16 metrics lie within 0.5 % of its float32 ones here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.ops.kernels import registry
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax, flax_to_state_dict
from tests.test_torch_precision_modules import flax_like_params
from tests.test_torch_rssm_continuous import N_ACT, _jax_actor, _port_cfg, jax_noise, step_batch, step_configs

BF16 = torch.bfloat16
B_ROWS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grad_recorder() -> optax.GradientTransformation:
    """Zero updates; the state holds the last gradient."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


class _Recorder:
    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def jax_agent(fabric, cfg, obs_space):
    """JAX's world model and critic modules, and parameters in the shapes
    its ``build_agent`` gives, read with ``jax.eval_shape`` (flax's eager
    initialisation takes half a minute on the CPU)."""
    built = {}

    def build():
        world_model, _, critic, params, _ = jax_build_agent(fabric, (N_ACT,), True, cfg, obs_space)
        built.update(world_model=world_model, critic=critic)
        return params

    params = flax_like_params(jax.eval_shape(build))
    return built["world_model"], built["critic"], params


def build_pair(backend: str = "pallas"):
    """One JAX gradient step and the port's, each with recording optimizers."""
    cfg, plain_cfg, obs_space = step_configs(["fabric.precision=bf16-mixed"])
    fabric = Fabric(devices=1, accelerator="cpu", precision="bf16-mixed")
    world_model, critic, params = jax_agent(fabric, cfg, obs_space)
    actor = _jax_actor(cfg, True)
    actor = actor.clone(dtype=jnp.bfloat16)
    txs = {name: grad_recorder() for name in ("world", "actor", "critic")}
    jparams = jax.tree.map(jnp.asarray, params)
    opts = {"world": txs["world"].init(jparams["world_model"]), "actor": txs["actor"].init(jparams["actor"]),
            "critic": txs["critic"].init(jparams["critic"])}
    data = step_batch(True)
    key = jax.random.PRNGKey(11)
    with registry.use_backend(backend):
        train_fn = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACT,), True, txs)
        _, opts, _, metrics = train_fn(jparams, opts, jax_init_moments(), data, key, jnp.int32(0))
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    noise = jax_noise(key, S, D, True, False)
    port = {prec: port_step(plain_cfg, params, data, noise, prec) for prec in ("bf16-mixed", "32-true")}
    grads = {}
    for name in ("world", "actor", "critic"):
        want = (dreamer_v3_state_from_jax({"world_model": jax.tree.map(np.asarray, opts["world"])})["world_model"]
                if name == "world" else flax_to_state_dict(jax.tree.map(np.asarray, opts[name])))
        got, f32 = port["bf16-mixed"]["grads"][name], port["32-true"]["grads"][name]
        grads[name] = {n: (got[n], want[n].numpy(), f32[n]) for n in got}
    return {"metrics": (port["bf16-mixed"]["metrics"], np.asarray(metrics).reshape(-1)), "grads": grads,
            "modules": port["bf16-mixed"]["modules"], "jax": (world_model, actor, critic, params), "data": data}


def port_step(plain_cfg, params, data, noise, precision):
    """The port's step at ``precision`` from the JAX parameters, its
    optimizers recording: the metrics, each module's gradients by name."""
    port_cfg = _port_cfg(plain_cfg, True)
    port_cfg["fabric"]["precision"] = precision
    wm, actor, critic, target = build_training_agent(port_cfg, "cpu", dreamer_v3_state_from_jax(params))
    modules = {"world": wm, "actor": actor, "critic": critic}
    recorders = {k: _Recorder(m.parameters()) for k, m in modules.items()}
    step = make_train_step(wm, actor, critic, target, recorders, port_cfg)
    _, metrics, _ = step({k: torch.from_numpy(v) for k, v in data.items()}, init_moments(), 0, noise=[noise])
    grads = {k: {n: g.numpy() for (n, _), g in zip(m.named_parameters(), recorders[k].grads)}
             for k, m in modules.items()}
    return {"metrics": metrics[0].numpy(), "grads": grads, "modules": (wm, actor, critic)}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=METRIC_NAMES)
def test_torch_precision_v3_step_metric_matches_jax(pair, index):
    got, want = (float(m[index]) for m in pair["metrics"])
    assert np.isfinite(got)
    assert abs(got - want) <= 2e-2 * abs(want) + 1e-3, f"{METRIC_NAMES[index]}: port {got}, JAX {want}"


def _distance(a, b) -> float:
    return 1.0 - cosine(a, b)


@pytest.mark.parametrize("module", ["world", "actor", "critic"])
def test_torch_precision_v3_step_gradients_match_jax(pair, module):
    grads = pair["grads"][module]
    for name, (got, _, _) in grads.items():
        assert got.dtype == np.float32, f"{module}.{name}: gradient dtype {got.dtype}"
    got, want, f32 = (np.concatenate([g[i].ravel() for g in grads.values()]) for i in range(3))
    assert not np.array_equal(got, f32), f"{module}: the bfloat16 step's gradient is its float32 one"
    d, d_port, d_jax = _distance(got, want), _distance(got, f32), _distance(want, f32)
    bound = max(1e-3, 2.0 * d_jax) if module == "world" else 1e-3
    assert d <= bound, (f"{module}: gradient cosine to JAX's {1 - d:.6f}, bound {1 - bound:.6f}; each side's to "
                        f"the float32 gradient {1 - d_port:.6f} (port), {1 - d_jax:.6f} (JAX)")


def test_torch_precision_v3_outputs_and_carry_have_jax_dtypes(pair):
    """One RSSM step from a fresh bf16 carry, then the decoders, heads and
    actor on its latent: each output and the carried state in JAX's dtype
    (bfloat16 from the bf16 modules; the one-hot posterior in the logits'
    dtype), and within 2e-2 of JAX's relative to its mean magnitude."""
    world_model, actor, critic, params = pair["jax"]
    wm, port_actor, port_critic = pair["modules"]
    data = pair["data"]
    obs = {"rgb": data["rgb"][0, 0] / 255.0 - 0.5, "state": data["state"][0, 0]}
    act, first = data["actions"][0, 0], np.ones((B_ROWS, 1), np.float32)
    rssm = world_model.rssm

    def jax_outputs(params, obs, act, first):
        wmp = params["world_model"]
        emb = world_model.encoder.apply(wmp["encoder"], obs)
        rec0 = jnp.zeros((B_ROWS, rssm.recurrent_model.recurrent_state_size), emb.dtype)
        post0 = jnp.zeros((B_ROWS, rssm.transition_model.stoch_state_size), emb.dtype)
        rec, post, post_logits, prior_logits = rssm.dynamic(wmp, post0, rec0, act, emb, first,
                                                            jax.random.PRNGKey(0))
        latent = jnp.concatenate([post, rec], axis=-1)
        return {"embedded": emb, "recurrent": rec, "posterior": post, "posterior_logits": post_logits,
                "prior_logits": prior_logits, "reward": world_model.reward_model.apply(wmp["reward_model"], latent),
                "continue": world_model.continue_model.apply(wmp["continue_model"], latent),
                "critic": critic.apply(params["critic"], latent), "actor": actor.apply(params["actor"], latent)[0],
                **world_model.decode(wmp, latent)}

    # one jit for the lot (flax's eager dispatch compiles op by op); the outputs' dtypes are
    # flax's either way, and the fusion's rounding sits far inside the bound
    with registry.use_backend("pallas"):
        want = jax.jit(jax_outputs)(params, obs, jnp.asarray(act), jnp.asarray(first))
    rec0, post0 = want["recurrent"], want["posterior"]
    post = want["posterior"]
    with torch.no_grad():
        t_obs = {k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()}
        t_emb = wm.encoder(t_obs)
        t_rec0 = torch.zeros(tuple(rec0.shape), dtype=t_emb.dtype)
        t_post0 = torch.zeros(tuple(post0.shape), dtype=t_emb.dtype)
        uniform = torch.from_numpy(np.full(tuple(post0.shape), 0.5, np.float32))
        t_rec, t_post, t_post_logits, t_prior_logits = wm.dynamic(
            t_post0, t_rec0, torch.from_numpy(act), t_emb, torch.from_numpy(first), uniform)
        t_latent = torch.cat([torch.from_numpy(np.asarray(post.astype(jnp.float32))).to(t_post.dtype), t_rec], -1)
        got = {"embedded": t_emb, "recurrent": t_rec, "posterior": t_post, "posterior_logits": t_post_logits,
               "prior_logits": t_prior_logits, "reward": wm.reward_model(t_latent),
               "continue": wm.continue_model(t_latent), "critic": port_critic(t_latent),
               "actor": port_actor(t_latent)[0], **wm.decode(t_latent)}
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), f"{k}: port {g.dtype}, JAX {w.dtype}"
        if k == "posterior":  # drawn from other noise: the one-hot shape only
            continue
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        err = float(np.mean(np.abs(g - w)))
        assert err <= 2e-2 * float(np.mean(np.abs(w))) + 1e-6, f"{k}: mean error {err} against {np.mean(np.abs(w))}"


def test_torch_precision_v3_parameters_stay_float32(pair):
    for m in pair["modules"]:
        assert {p.dtype for p in m.parameters()} == {torch.float32}
        assert {b.dtype for b in m.buffers()} <= {torch.float32}
