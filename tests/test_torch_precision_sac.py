"""The port's SAC at ``fabric.precision=bf16-mixed`` against the JAX
package's on the CPU: one gradient step of the host path's
``make_train_step`` at the small size of ``tests/test_torch_sac_update.py``
(hidden 32, batch 16, 2 critics, Pendulum's 3 observations and 1 torque),
from the same float32 parameters and on JAX's own draws (its bfloat16
normals: the JAX package draws the squashed Gaussian's noise in the
actor's dtype).

Every optimizer is a recorder that keeps the gradient and leaves the
parameters as they are, on both sides, so each gradient is read exactly.
Bounds: the three losses within 2e-2 relative (1e-3 absolute); each
module's gradient (actor, critic, ``log_alpha``, each as one vector) has
cosine similarity at least 0.999 to JAX's; the actor's and the critics'
outputs and the sampled actions in bfloat16 as JAX's; the parameters stay
float32. What each comparison measured is in its assertion message.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac.sac import make_train_step as jax_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax
from tests.test_torch_precision_modules import flax_like_params
from tests.test_torch_precision_v3 import _Recorder, cosine, grad_recorder

HIDDEN, BATCH, OBS, ACT = 32, 16, 3, 1
OVERRIDES = [f"algo.hidden_size={HIDDEN}", f"algo.per_rank_batch_size={BATCH}", "env.num_envs=2",
             "fabric.precision=bf16-mixed"]
ACTION_SPACE = {"shape": [ACT], "low": [-2.0], "high": [2.0]}
LOSSES = ("qf_loss", "actor_loss", "alpha_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_sac(cfg):
    """JAX's SAC agent under ``bf16-mixed`` and parameters in the shapes
    its ``build_agent`` gives (``jax.eval_shape``: no initialisation is
    compiled)."""
    fabric = Fabric(devices=1, accelerator="cpu", precision="bf16-mixed")
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32)
    built = {}

    def build():
        agent, params, _ = jax_build_agent(fabric, cfg, obs_space, act_space)
        built["agent"] = agent
        return params

    params = flax_like_params(jax.eval_shape(build), seed=3)
    params["target_critic"] = params["critic"]
    return fabric, built["agent"], params


@pytest.fixture(scope="module")
def pair():
    cfg = compose(["exp=sac"] + OVERRIDES)
    fabric, jagent, params = jax_sac(cfg)
    rng = np.random.default_rng(8)
    data = {
        "observations": rng.normal(size=(1, BATCH, OBS)).astype(np.float32),
        "next_observations": rng.normal(size=(1, BATCH, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(1, BATCH, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(1, BATCH, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(1, BATCH, 1)) < 0.2).astype(np.float32),
    }
    txs = [grad_recorder() for _ in range(3)]
    opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
    key = jax.random.PRNGKey(11)
    step = jax_train_step(jagent, *txs, cfg, fabric.mesh, donate=False, guard=False)
    _, aopt, copt, lopt, qf, al, ll = step(params, *opts, data, key, jnp.float32(1.0))
    k_next, k_actor = jax.random.split(jax.random.split(jax.random.fold_in(key, 0), 1)[0])
    noise = {name: torch.from_numpy(np.asarray(jax.random.normal(k, (1, BATCH, ACT), jnp.bfloat16), np.float32))
             for name, k in (("next", k_next), ("actor", k_actor))}

    pcfg = apply_overrides(preset("sac"), OVERRIDES + [f"algo.actor.hidden_size={HIDDEN}",
                                                       f"algo.critic.hidden_size={HIDDEN}"])
    agent, _ = build_agent(pcfg, OBS, ACTION_SPACE, "cpu", sac_state_from_jax(jax.tree.map(np.asarray, params)))
    recorders = (_Recorder(agent.actor.parameters()), _Recorder(agent.critic.parameters()),
                 _Recorder([agent.log_alpha]))
    losses, _ = make_train_step(agent, recorders, pcfg)({k: torch.from_numpy(v) for k, v in data.items()}, True,
                                                        noise=noise)
    want = sac_state_from_jax({"actor": jax.tree.map(np.asarray, aopt), "critic": jax.tree.map(np.asarray, copt),
                               "target_critic": jax.tree.map(np.asarray, copt),
                               "log_alpha": np.asarray(lopt)})
    grads = {
        "actor": ([g.numpy() for g in recorders[0].grads],
                  [want[f"actor.{n}"].numpy() for n, _ in agent.actor.named_parameters()]),
        "critic": ([g.numpy() for g in recorders[1].grads],
                   [want[f"critic.{n}"].numpy() for n, _ in agent.critic.named_parameters()]),
        "log_alpha": ([recorders[2].grads[0].numpy()], [want["log_alpha"].numpy()]),
    }
    obs = torch.from_numpy(data["observations"][0])
    with torch.no_grad():
        outputs = {"mean": agent.actor(obs)[0], "q": agent.q_values(obs, torch.from_numpy(data["actions"][0])),
                   "action": agent.sample_action(obs, noise["actor"][0])[0], "greedy": agent.greedy_action(obs)}

    def jax_side(params, obs, actions, key):  # one jit: flax's eager dispatch compiles op by op
        return {"mean": jagent.actor.apply(params["actor"], obs)[0],
                "q": jagent.q_values(params["critic"], obs, actions),
                "action": jagent.sample_action(params["actor"], obs, key)[0],
                "greedy": jagent.greedy_action(params["actor"], obs)}

    jax_outputs = jax.jit(jax_side)(params, data["observations"][0], data["actions"][0], k_actor)
    return {"losses": (losses.numpy(), np.array([float(qf), float(al), float(ll)])), "grads": grads,
            "outputs": (outputs, jax_outputs), "agent": agent}


@pytest.mark.parametrize("index", range(3), ids=LOSSES)
def test_torch_precision_sac_step_loss_matches_jax(pair, index):
    got, want = (float(x[index]) for x in pair["losses"])
    assert abs(got - want) <= 2e-2 * abs(want) + 1e-3, f"{LOSSES[index]}: port {got}, JAX {want}"


@pytest.mark.parametrize("module", ["actor", "critic", "log_alpha"])
def test_torch_precision_sac_step_gradients_match_jax(pair, module):
    got, want = (np.concatenate([g.ravel() for g in side]) for side in pair["grads"][module])
    assert got.dtype == np.float32
    c = cosine(got, want)
    assert c >= 0.999, f"{module}: gradient cosine {c}"


def test_torch_precision_sac_outputs_have_jax_dtypes(pair):
    """The actor's mean, the critics' Q-values, a sampled and a greedy
    action: each in JAX's dtype (bfloat16) and within 2e-2 of JAX's relative
    to its mean magnitude."""
    got, want = pair["outputs"]
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), f"{k}: port {g.dtype}, JAX {w.dtype}"
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        err = float(np.mean(np.abs(g - w)))
        assert err <= 2e-2 * float(np.mean(np.abs(w))) + 1e-6, f"{k}: mean error {err}"
    assert {p.dtype for p in pair["agent"].parameters()} == {torch.float32}
