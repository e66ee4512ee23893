"""The guarded PPO update of the port (``make_train_step(guard=True)``)
against the JAX package's ``make_train_step(guard=True)`` on a one-device
mesh, on the CPU, with NaN advantages in chosen minibatches.

The sizes and data of ``test_torch_ppo_update.py`` (4 envs x 16 steps, 2
epochs, minibatches of 8, or of 12 padded cyclically with advantage
normalisation on). Rows are poisoned with NaN so that chosen minibatches
of JAX's own permutations hold them: each poisoned row sits in one
minibatch per epoch. A skipped minibatch leaves the parameters, Adam's
moments and its step count as they were, on both sides.

Tolerances: the skipped count exact; every parameter within atol 1e-6 of
JAX's after the steps taken (a step moves a parameter by up to the learning
rate, 1e-3), both Adam moments within 1e-5 as in
``test_torch_ppo_update.py`` (sums of gradients of the same float32 forward
in another summation order); the Adam step count exact; with every row
poisoned, the parameters and Adam's state bit-equal to before.
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
from sheeprl_tpu.ops import finite_guard as jax_finite_guard
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.ops.guard import StateGuard, finite_guard, guarded_select
from sheeprl_tpu_torch.utils.convert import ppo_state_from_jax
from tests.test_torch_ppo_update import CASES, EPOCHS, ROWS, _adam_state, _data, _overrides, jax_permutations

KEY = 3
# (epoch, minibatch) slots whose first row is poisoned; "all" poisons every row
POISON = {"one-minibatch": [(0, 2)], "two-minibatches": [(0, 0), (1, 5)], "all": "all"}


def _poisoned(case: str, poison: str):
    data = _data(1)
    perms = jax_permutations(jax.random.PRNGKey(KEY), EPOCHS, ROWS)
    mb = CASES[case]["mb"]
    if poison == "all":
        data["advantages"][:] = np.nan
    else:
        for epoch, m in POISON[poison]:
            data["advantages"][perms[epoch][m * mb]] = np.nan
    return data, perms


def _expected_skips(data, perms, mb):
    """Minibatches holding a NaN row, with JAX's cyclic padding."""
    n_mb = -(-ROWS // mb)
    bad = np.isnan(data["advantages"][:, 0])
    cyclic = np.arange(n_mb * mb) % ROWS
    return sum(int(bad[p[cyclic]].reshape(n_mb, mb).any(axis=1).sum()) for p in perms)


@pytest.fixture(scope="module", params=[(c, p) for c in CASES for p in POISON], ids=lambda cp: f"{cp[0]}-{cp[1]}")
def guarded(request):
    case, poison = request.param
    cfg = compose(["exp=ppo"] + _overrides(case))
    port_cfg = apply_overrides(preset("ppo"), _overrides(case))
    jax_agent = JaxPPOAgent(
        actions_dim=(2,), is_continuous=False, cnn_keys=(), mlp_keys=("state",),
        encoder_cfg=dict(cfg.algo.encoder), actor_cfg=dict(cfg.algo.actor), critic_cfg=dict(cfg.algo.critic),
    )
    params = jax_agent.init(jax.random.PRNGKey(0), {"state": jnp.zeros((1, 4), jnp.float32)})
    before = jax.tree.map(np.asarray, params)
    tx = optax.inject_hyperparams(
        lambda learning_rate: jax_build_optimizer(
            {**cfg.algo.optimizer, "lr": learning_rate}, max_grad_norm=cfg.algo.max_grad_norm
        )
    )(learning_rate=float(cfg.algo.optimizer.lr))
    opt_state = tx.init(params)
    train = jax_make_train_step(jax_agent, tx, cfg, Fabric(devices=1, accelerator="cpu").mesh, ROWS, donate=False,
                                guard=True)
    data, perms = _poisoned(case, poison)
    new_params, new_opt, _, _, _, skipped = train(
        params, opt_state, data, jax.random.PRNGKey(KEY), jnp.float32(0.2), jnp.float32(0.01)
    )

    agent, _ = build_agent(port_cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", ppo_state_from_jax(before))
    optimizer = make_optimizer(port_cfg, agent)
    state_before = [t.clone() for t in list(agent.parameters()) + optimizer.state_tensors()]
    port_train = make_train_step(agent, optimizer, port_cfg, ROWS, guard=True)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, port_skipped = port_train({k: torch.from_numpy(a) for k, a in data.items()}, 0.2, 0.01,
                                     perms=torch.from_numpy(perms))
    finally:
        torch.set_num_threads(n_threads)
    adam = _adam_state(new_opt)
    names = dict((p, n) for n, p in agent.named_parameters())
    port_state = optimizer.optimizer.state
    return {
        "case": case, "poison": poison, "data": data, "perms": perms,
        "jax": {
            "skipped": float(skipped), "count": int(adam.count),
            "params": ppo_state_from_jax(jax.tree.map(np.asarray, new_params)),
            "mu": ppo_state_from_jax(jax.tree.map(np.asarray, adam.mu)),
            "nu": ppo_state_from_jax(jax.tree.map(np.asarray, adam.nu)),
        },
        "port": {
            "skipped": float(port_skipped),
            "steps": {int(s["step"]) for s in port_state.values()},
            "params": {k: v.detach().clone() for k, v in agent.state_dict().items()},
            "mu": {names[p]: s["exp_avg"] for p, s in port_state.items()},
            "nu": {names[p]: s["exp_avg_sq"] for p, s in port_state.items()},
            "state": list(agent.parameters()) + optimizer.state_tensors(),
        },
        "state_before": state_before,
    }


def test_torch_fault_ppo_skipped_count_matches_jax(guarded):
    want = _expected_skips(guarded["data"], guarded["perms"], CASES[guarded["case"]]["mb"])
    assert guarded["jax"]["skipped"] == want > 0
    assert guarded["port"]["skipped"] == want


def test_torch_fault_ppo_adam_step_count_matches_jax(guarded):
    assert guarded["port"]["steps"] == {guarded["jax"]["count"]}


@pytest.mark.parametrize("what, atol", [("params", 1e-6), ("mu", 1e-5), ("nu", 1e-5)])
def test_torch_fault_ppo_state_matches_jax(guarded, what, atol):
    got, want = guarded["port"][what], guarded["jax"][what]
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.isfinite(got[name]).all(), f"{what} {name}"
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=atol, rtol=0, err_msg=f"{what} {name}")


def test_torch_fault_ppo_state_moves_only_when_a_minibatch_is_taken(guarded):
    """Every row poisoned: the parameters and Adam's state (step counts
    included) bit-equal to before; else the update still moved them."""
    same = [torch.equal(got, want) for got, want in zip(guarded["port"]["state"], guarded["state_before"])]
    if guarded["poison"] == "all":
        assert all(same)
    else:
        assert not any(same)


@pytest.mark.parametrize(
    "values",
    [[1.0, 2.0], [1e20, -3.0], [np.nan, 0.0], [np.inf, 1.0], [-np.inf, 0.0], [3.0e38, 3.0e38]],
    ids=["finite", "huge-finite", "nan", "inf", "minus-inf", "near-max"],
)
def test_torch_fault_finite_guard_matches_jax(values):
    """The verdict per tensor list against JAX's ``finite_guard``: a finite
    1e20 (whose squared 2-norm overflows) is finite on both sides."""
    arrays = [np.asarray(values, np.float32), np.ones((2, 3), np.float32), np.float32(0.5)]
    want = bool(jax_finite_guard([jnp.asarray(a) for a in arrays]))
    got = finite_guard([torch.as_tensor(a) for a in arrays])
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want


@pytest.mark.parametrize("ok", [True, False])
def test_torch_fault_state_guard_select_is_nan_safe(ok):
    """``StateGuard`` and ``guarded_select`` keep the old state bit for bit
    where the verdict is False, even over NaN and Inf, and take the new one
    where it is True; tensors of two dtypes form two groups."""
    gen = torch.Generator().manual_seed(0)
    state = [torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen), torch.zeros(()),
             torch.randn(2, generator=gen, dtype=torch.float64)]
    guard = StateGuard(lambda: state)
    guard.snapshot()
    old = [t.clone() for t in state]
    for t in state:
        t.add_(float("nan")) if t.dim() == 1 else t.add_(float("inf"))
    new = [t.clone() for t in state]
    guard.select(torch.tensor(ok))
    for got, before, after in zip(state, old, new):
        want = after if ok else before
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)) and torch.equal(got.isnan(), want.isnan())
    picked = guarded_select(torch.tensor(ok), new, old)
    for got, before, after in zip(picked, old, new):
        want = after if ok else before
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
