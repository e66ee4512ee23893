"""The port's RMSprop (``sheeprl_tpu_torch/optim/builders.py``, optax's op
order) behind the global-norm clip, against the JAX package's
``build_optimizer`` (``optax.clip_by_global_norm`` chained before
``optax.rmsprop(..., eps_in_sqrt=False)``), on the CPU: 20 steps of the same
numpy gradients, some under and some over the clip; every parameter and the
second moment ``nu`` within 1e-6 after each step (float32 on both sides, the
same ops in the same order: they read equal). Also: the state survives a
``state_dict`` round trip mid-way, a weight decay is added to the gradient
first, and the forms that are not ported raise."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.optim.builders import RMSprop, rmsprop

TOL = 1e-6
CASES = {
    "a2c": dict(lr=1e-3, alpha=0.99, eps=1e-4, weight_decay=0.0, clip=0.5),
    "unclipped": dict(lr=3e-3, alpha=0.9, eps=1e-8, weight_decay=0.0, clip=None),
    "weight-decay": dict(lr=1e-3, alpha=0.99, eps=1e-4, weight_decay=0.01, clip=1.0),
}
SHAPES = [(4, 64), (64,), (64, 2), (2,)]


def _cfg(c):
    return {"_target_": "sheeprl_tpu.optim.rmsprop", "lr": c["lr"], "alpha": c["alpha"], "eps": c["eps"],
            "weight_decay": c["weight_decay"], "momentum": 0, "centered": False}


def _nu(opt_state):
    found = []

    def visit(node):
        if hasattr(node, "nu"):
            found.append(node.nu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                visit(child)

    visit(opt_state)
    return found[0]


@pytest.mark.parametrize("case", list(CASES))
def test_torch_rmsprop_matches_optax_over_20_steps(case):
    c = CASES[case]
    rng = np.random.default_rng(7)
    start = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    tx = jax_build_optimizer(_cfg(c), max_grad_norm=c["clip"])
    j_params = [jnp.asarray(p) for p in start]
    j_state = tx.init(j_params)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in start]
    opt = build_optimizer(params, _cfg(c), c["clip"])
    clipped = 0
    for step in range(20):
        scale = 5.0 if step % 2 else 0.001  # the global norm over and under the clip in turns
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]
        clipped += float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))) >= (c["clip"] or np.inf)
        updates, j_state = tx.update([jnp.asarray(g) for g in grads], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        if step == 9:  # a round trip through the state dict changes nothing
            saved = opt.state_dict()
            opt = build_optimizer(params, _cfg(c), c["clip"])
            opt.load_state_dict(saved)
        for got, want in zip(params, j_params):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
        for p, want in zip(params, _nu(j_state)):
            np.testing.assert_allclose(opt.optimizer.state[p]["nu"].numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert clipped == (10 if c["clip"] else 0)
    assert isinstance(opt.optimizer, RMSprop) and not opt.capturable


def test_torch_rmsprop_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(NotImplementedError, match="momentum"):
        rmsprop(p, momentum=0.9)
    with pytest.raises(NotImplementedError, match="centered"):
        rmsprop(p, centered=True)
    with pytest.raises(NotImplementedError, match="rmsprop"):
        build_optimizer(p, {"_target_": "sheeprl_tpu.optim.sgd", "lr": 1e-3})


def test_torch_rmsprop_state_exists_before_the_first_step():
    p = torch.nn.Parameter(torch.ones(2, 3))
    opt = rmsprop([p], lr=1e-2)
    assert torch.equal(opt.state[p]["nu"], torch.zeros(2, 3))
    p.grad = torch.full((2, 3), 2.0)
    opt.step()
    # nu = 0.01 * 4; u = 2 / (sqrt(0.04) + 1e-8); p = 1 - 1e-2 * u
    np.testing.assert_allclose(opt.state[p]["nu"].numpy(), np.float32(0.01) * 4, rtol=1e-6)
    np.testing.assert_allclose(p.detach().numpy(), 1 - 1e-2 * 2 / (0.2 + 1e-8), rtol=1e-6)
