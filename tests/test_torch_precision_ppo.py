"""The port's PPO at ``fabric.precision=bf16-mixed`` against the JAX
package's on the CPU: one gradient step of ``make_train_step`` (one epoch,
one minibatch of all 64 rows, advantage normalisation and ``clip_vloss`` on)
at the CartPole recipe's widths, from the same float32 parameters, the rows
in JAX's own permutation (rebuilt from the step's key as
``tests/test_torch_ppo_update.py`` does).

Both optimizers are recorders that keep the gradient and leave the
parameters as they are. Bounds: the three losses within 2e-2 relative
(1e-3 absolute); the whole gradient (one vector) has cosine similarity at
least 0.999 to JAX's; the actor's logits and the critic's values in
bfloat16 as JAX's, within 2e-2 of them relative to their mean magnitude;
the parameters stay float32. What each comparison measured is in its
assertion message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax
from tests.test_torch_ppo_update import _data, jax_permutations
from tests.test_torch_precision_modules import flax_like_params
from tests.test_torch_precision_v3 import _Recorder, cosine, grad_recorder

ROWS = 64
OVERRIDES = ["env.num_envs=4", "algo.rollout_steps=16", f"algo.per_rank_batch_size={ROWS}", "algo.update_epochs=1",
             "algo.normalize_advantages=True", "algo.clip_vloss=True", "fabric.precision=bf16-mixed"]


@pytest.fixture(scope="module")
def pair():
    cfg = compose(["exp=ppo"] + OVERRIDES)
    jax_agent = JaxPPOAgent(
        actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
        encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic),
        dtype=jnp.bfloat16,
    )
    params = flax_like_params(jax.eval_shape(jax_agent.init, jax.random.PRNGKey(0),
                                             {"state": jnp.zeros((1, 4), jnp.float32)}), seed=5)
    tx = grad_recorder()
    fabric = Fabric(devices=1, accelerator="cpu", precision="bf16-mixed")
    train = jax_make_train_step(jax_agent, tx, cfg, fabric.mesh, ROWS, donate=False, guard=False)
    data = _data(1)
    key = jax.random.PRNGKey(3)
    _, grads, pg, v, ent = train(params, tx.init(params), data, key, jnp.float32(0.2), jnp.float32(0.01))
    port_cfg = apply_overrides(preset("ppo"), OVERRIDES)
    agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_state_from_jax(params))
    recorder = _Recorder(agent.parameters())
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, _ = make_train_step(agent, recorder, port_cfg, ROWS)(
            {k: torch.from_numpy(a) for k, a in data.items()}, 0.2, 0.01,
            perms=torch.from_numpy(jax_permutations(key, 1, ROWS)))
    finally:
        torch.set_num_threads(n_threads)
    want = ppo_state_from_jax(jax.tree.map(np.asarray, grads))
    names = [n for n, _ in agent.named_parameters()]
    with torch.no_grad():
        logits, values = agent({"state": torch.from_numpy(data["state"])})
    jax_logits, jax_values = jax_agent.apply(params, {"state": data["state"]})
    return {
        "losses": (losses.numpy(), np.array([float(pg), float(v), float(ent)])),
        "grads": (np.concatenate([g.numpy().ravel() for g in recorder.grads]),
                  np.concatenate([want[n].numpy().ravel() for n in names])),
        "outputs": ({"logits": logits[0], "values": values}, {"logits": jax_logits[0], "values": jax_values}),
        "agent": agent,
    }


@pytest.mark.parametrize("index", range(3), ids=LOSS_NAMES)
def test_torch_precision_ppo_step_loss_matches_jax(pair, index):
    got, want = (float(x[index]) for x in pair["losses"])
    assert abs(got - want) <= 2e-2 * abs(want) + 1e-3, f"{LOSS_NAMES[index]}: port {got}, JAX {want}"


def test_torch_precision_ppo_step_gradient_matches_jax(pair):
    got, want = pair["grads"]
    assert got.dtype == np.float32
    c = cosine(got, want)
    assert c >= 0.999, f"gradient cosine {c}"


def test_torch_precision_ppo_outputs_have_jax_dtypes(pair):
    got, want = pair["outputs"]
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), f"{k}: port {g.dtype}, JAX {w.dtype}"
        g, w = g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))
        err = float(np.mean(np.abs(g - w)))
        assert err <= 2e-2 * float(np.mean(np.abs(w))) + 1e-6, f"{k}: mean error {err}"
    assert {p.dtype for p in pair["agent"].parameters()} == {torch.float32}
