"""One A2C update of the port (``sheeprl_tpu_torch/algos/a2c/a2c.py``
``make_train_step``) against the JAX package's ``make_train_step`` on a
one-device mesh, on the CPU, with JAX's own permutation (rebuilt from the
step's key: ``fold_in`` of the device index, then ``permutation``).

The recipe's shape: 4 envs x 5 rollout steps (20 rows) in minibatches of 5,
``loss_reduction`` sum, the gradients of the 4 minibatches summed, clipped
at 0.5 and applied by one RMSprop step (lr 1e-3, eps 1e-4). Beside it: the
mean reduction with minibatches of 6 (the last padded with 4 rows of
weight 0), a continuous agent (2 action dims) and a multi-discrete one (2
and 3 actions). Both sides start from the same flax weights
(``a2c_state_from_jax``).

Tolerances (float32 on both sides, the gradients summed in minibatch order
on both, each minibatch's own gradient rounded in another op order): the
two mean losses within rtol 1e-5; every parameter and RMSprop's ``nu``
after the step within rtol 1e-5 (atol 1e-7 for a near-zero element). The
first RMSprop step moves a parameter by about 10 x lr, so a wrong gradient
direction or scale shows at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.a2c.a2c import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.ppo.agent import PPOAgent as JaxPPOAgent
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.a2c.a2c import LOSS_NAMES, make_optimizer, make_train_step
from sheeprl_tpu_torch.algos.a2c.agent import build_agent
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.convert import a2c_state_from_jax

N_ENVS, T = 4, 5
ROWS = N_ENVS * T
CASES = {
    "recipe-sum": dict(mb=5, reduction="sum", dims=(2,), continuous=False),
    "mean-padded": dict(mb=6, reduction="mean", dims=(2,), continuous=False),
    "continuous": dict(mb=5, reduction="sum", dims=(2,), continuous=True),
    "multi-discrete": dict(mb=5, reduction="sum", dims=(2, 3), continuous=False),
}


def _overrides(c):
    return [f"algo.per_rank_batch_size={c['mb']}", f"algo.loss_reduction={c['reduction']}"]


def _data(seed, c):
    rng = np.random.default_rng(seed)
    if c["continuous"]:
        actions = rng.normal(size=(ROWS, sum(c["dims"]))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, ROWS)] for d in c["dims"]], -1)
    return {
        "state": rng.normal(size=(ROWS, 4)).astype(np.float32),
        "actions": actions,
        "values": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "returns": (rng.normal(size=(ROWS, 1)) * 2).astype(np.float32),
        "advantages": rng.normal(size=(ROWS, 1)).astype(np.float32),
        "rewards": np.ones((ROWS, 1), np.float32),
        "dones": (rng.uniform(size=(ROWS, 1)) < 0.1).astype(np.uint8),
    }


def jax_permutation(key, rows):
    """``local_train``'s permutation on device 0 of the mesh."""
    return np.asarray(jax.random.permutation(jax.random.fold_in(key, 0), rows))


def _nu(tree):
    found = []

    def visit(node):
        if hasattr(node, "nu"):
            found.append(node.nu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(tree)
    return found[0]


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    c = CASES[request.param]
    cfg = compose(["exp=a2c"] + _overrides(c))
    port_cfg = apply_overrides(preset("a2c"), _overrides(c))
    jax_agent = JaxPPOAgent(actions_dim=c["dims"], is_continuous=c["continuous"], cnn_keys=(), mlp_keys=("state",),
                            encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor),
                            critic_cfg=dict(cfg.algo.critic))
    params = jax_agent.init(jax.random.PRNGKey(1), {"state": jnp.zeros((1, 4), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = jax_build_optimizer(cfg.algo.optimizer, max_grad_norm=cfg.algo.max_grad_norm)
    opt_state = tx.init(params)
    train = jax_make_train_step(jax_agent, tx, cfg, Fabric(devices=1, accelerator="cpu").mesh, ROWS)
    data = _data(2, c)
    key = jax.random.PRNGKey(5)
    new_params, new_opt, pg, v = train(jax.tree.map(jnp.asarray, before), opt_state, data, key)

    agent, _ = build_agent(port_cfg, c["dims"], c["continuous"], {"state": {"shape": [4]}}, "cpu",
                           a2c_state_from_jax(before))
    optimizer = make_optimizer(port_cfg, agent)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = make_train_step(agent, optimizer, port_cfg, ROWS)(
            {k: torch.from_numpy(np.array(a)) for k, a in data.items()},
            perm=torch.from_numpy(np.array(jax_permutation(key, ROWS))))
    finally:
        torch.set_num_threads(n_threads)
    names = {p: n for n, p in agent.named_parameters()}
    return {
        "jax": {"losses": [float(pg), float(v)], "params": a2c_state_from_jax(jax.tree.map(np.asarray, new_params)),
                "nu": a2c_state_from_jax(jax.tree.map(np.asarray, _nu(new_opt)))},
        "port": {"losses": losses.tolist(), "params": {k: t.detach().clone() for k, t in agent.state_dict().items()},
                 "nu": {names[p]: s["nu"] for p, s in optimizer.optimizer.state.items()}},
        "before": a2c_state_from_jax(before),
    }


def test_torch_a2c_update_permutation_is_jax_s():
    perm = jax_permutation(jax.random.PRNGKey(5), ROWS)
    np.testing.assert_array_equal(np.sort(perm), np.arange(ROWS))
    assert not np.array_equal(perm, np.arange(ROWS))


@pytest.mark.parametrize("index", range(2), ids=[n.split("/")[1] for n in LOSS_NAMES])
def test_torch_a2c_update_losses_match_jax(update, index):
    got, want = update["port"]["losses"][index], update["jax"]["losses"][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=LOSS_NAMES[index])


@pytest.mark.parametrize("what", ["params", "nu"])
def test_torch_a2c_update_state_matches_jax(update, what):
    got, want = update["port"][what], update["jax"][what]
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{what} {name}")
    if what == "params":  # one step moved every tensor
        assert all(not np.array_equal(v.numpy(), update["before"][n].numpy()) for n, v in want.items())
