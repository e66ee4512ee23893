"""One PPO update of the port (``make_train_step``) against the JAX package's
``make_train_step`` on a one-device mesh (``guard=False``), on the CPU.

A small size of the CartPole recipe: 4 envs x 16 rollout steps (64 rows), 2
epochs, minibatches of 8 (8 per epoch) or of 12 (6 per epoch, the last one
padded cyclically from the permutation's start), advantage normalisation
off and on, ``clip_vloss`` off and on, entropy coefficient 0.01. Both sides
start from the same flax weights (carried by ``ppo_state_from_jax``) and a
fresh Adam. The permutations are JAX's own: the test rebuilds them from the
step's key (``fold_in`` of the device index, ``split`` per epoch,
``permutation``) and hands them to the port, which pads them as
``jnp.resize`` does.

Tolerances (float32 on both sides): the three mean losses within rtol 1e-5;
every parameter and both Adam moments after 12-16 Adam steps within atol
1e-5 (a step moves a parameter by up to the learning rate, 1e-3, so a wrong
update shows at 1e-4; the moments are sums of gradients of the same
float32 forward in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.algos.ppo.ppo import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax

N_ENVS, T, EPOCHS = 4, 16, 2
ROWS = N_ENVS * T
CASES = {
    "mb8": dict(mb=8, normalize=False, clip_vloss=False),
    "mb12-padded-normalized": dict(mb=12, normalize=True, clip_vloss=True),
}


def _overrides(case):
    c = CASES[case]
    return [
        f"env.num_envs={N_ENVS}",
        f"algo.rollout_steps={T}",
        f"algo.per_rank_batch_size={c['mb']}",
        f"algo.update_epochs={EPOCHS}",
        f"algo.normalize_advantages={c['normalize']}",
        f"algo.clip_vloss={c['clip_vloss']}",
    ]


def _data(seed):
    rng = np.random.default_rng(seed)
    return {
        "state": rng.normal(size=(ROWS, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, ROWS)],
        "logprobs": (np.log(0.5) + 0.2 * rng.normal(size=(ROWS, 1))).astype(np.float32),
        "values": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "returns": (rng.normal(size=(ROWS, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "rewards": np.ones((ROWS, 1), np.float32),
        "dones": (rng.uniform(size=(ROWS, 1)) < 0.1).astype(np.uint8),
    }


def _adam_state(tree):
    """The ``ScaleByAdamState`` inside optax's injected chain."""
    found = []

    def visit(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(tree)
    (adam,) = found
    return adam


def jax_permutations(key, epochs, rows):
    """``make_local_train``'s per-epoch permutations on device 0 of the mesh."""
    key = jax.random.fold_in(key, 0)
    return np.stack([np.asarray(jax.random.permutation(k, rows)) for k in jax.random.split(key, epochs)])


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    case = request.param
    cfg = compose(["exp=ppo"] + _overrides(case))
    port_cfg = apply_overrides(preset("ppo"), _overrides(case))
    jax_agent = JaxPPOAgent(
        actions_dim=(2,),
        is_continuous=False,
        cnn_keys=(),
        mlp_keys=("state",),
        encoder_cfg=dict(cfg.algo.encoder),
        actor_cfg=dict(cfg.algo.actor),
        critic_cfg=dict(cfg.algo.critic),
    )
    params = jax_agent.init(jax.random.PRNGKey(0), {"state": jnp.zeros((1, 4), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = optax.inject_hyperparams(
        lambda learning_rate: jax_build_optimizer(
            {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm
        )
    )(learning_rate=float(cfg.algo.optimizer.lr))
    opt_state = tx.init(params)
    fabric = Fabric(devices=1, accelerator="cpu")
    train = jax_make_train_step(jax_agent, tx, cfg, fabric.mesh, ROWS, donate=False, guard=False)
    data = _data(1)
    key = jax.random.PRNGKey(3)
    new_params, new_opt, pg, v, ent = train(params, opt_state, data, key, jnp.float32(0.2), jnp.float32(0.01))

    agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_state_from_jax(before))
    optimizer = make_optimizer(port_cfg, agent)
    port_train = make_train_step(agent, optimizer, port_cfg, ROWS)
    perms = torch.from_numpy(jax_permutations(key, EPOCHS, ROWS))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, _ = port_train({k: torch.from_numpy(a) for k, a in data.items()}, 0.2, 0.01, perms=perms)
    finally:
        torch.set_num_threads(n_threads)
    adam = _adam_state(new_opt)
    names = dict((p, n) for n, p in agent.named_parameters())
    port_state = optimizer.optimizer.state
    return {
        "jax": {
            "losses": [float(pg), float(v), float(ent)],
            "params": ppo_state_from_jax(jax.tree.map(np.asarray, new_params)),
            "mu": ppo_state_from_jax(jax.tree.map(np.asarray, adam.mu)),
            "nu": ppo_state_from_jax(jax.tree.map(np.asarray, adam.nu)),
        },
        "port": {
            "losses": losses.tolist(),
            "params": {k: v.detach().clone() for k, v in agent.state_dict().items()},
            "mu": {names[p]: s["exp_avg"] for p, s in port_state.items()},
            "nu": {names[p]: s["exp_avg_sq"] for p, s in port_state.items()},
            "steps": {int(s["step"]) for s in port_state.values()},
        },
        "before": ppo_state_from_jax(before),
        "case": case,
    }


def test_torch_ppo_update_permutations_are_jax_s(update):
    """The rebuilt permutations are permutations, one per epoch, and differ
    between epochs."""
    perms = jax_permutations(jax.random.PRNGKey(3), EPOCHS, ROWS)
    assert perms.shape == (EPOCHS, ROWS)
    for p in perms:
        np.testing.assert_array_equal(np.sort(p), np.arange(ROWS))
    assert not np.array_equal(perms[0], perms[1])


@pytest.mark.parametrize("index", range(3), ids=[n.split("/")[1] for n in LOSS_NAMES])
def test_torch_ppo_update_losses_match_jax(update, index):
    got, want = update["port"]["losses"][index], update["jax"]["losses"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=LOSS_NAMES[index])


@pytest.mark.parametrize("what", ["params", "mu", "nu"])
def test_torch_ppo_update_state_matches_jax(update, what):
    got, want = update["port"][what], update["jax"][what]
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=f"{what} {name}")
    if what == "params":
        moved = [n for n, v in want.items() if not np.array_equal(v.numpy(), update["before"][n].numpy())]
        assert len(moved) == len(want)
        n_mb = -(-ROWS // CASES[update["case"]]["mb"])
        assert update["port"]["steps"] == {EPOCHS * n_mb}
