"""The port's optimizer for a config with ``weight_decay`` (every Dreamer V2
optimizer: ``weight_decay`` 1e-6) against the JAX package's, which turns it
into ``optax.adamw``: ``build_optimizer`` with the V2 recipe's settings
(``lr``, ``eps`` 1e-5, ``betas``, global-norm clipping at 100) over six
steps of the same gradients (each from JAX's parameters, the moments carried
on each side), the parameters within 1e-7 or, where the two
update orders round apart (torch decays ``p * (1 - lr * wd)`` first, optax
adds ``lr * wd * p`` to the Adam step), one float32 ulp of the parameter
(measured: 1 of 96 elements, 1.19e-7 at 1.09); a config without
weight decay stays plain Adam. On the CPU the update is torch's ``foreach``
``AdamW``; on the card the same builder makes it fused and capturable, as
its Adam (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``
check that form)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.optim import build_optimizer

SHAPES = {"w": (7, 5), "b": (5,), "conv": (3, 2, 4, 4)}


def _grads(rng, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [None, 100.0, 0.5], ids=["no_clip", "clip_100", "clip_tight"])
@pytest.mark.parametrize("lr, weight_decay", [(3e-4, 1e-6), (8e-5, 1e-6), (1e-3, 1e-2)])
def test_torch_adamw_matches_optax_adamw(lr, weight_decay, clip):
    cfg = {"_target_": "adam", "lr": lr, "eps": 1e-5, "weight_decay": weight_decay, "betas": [0.9, 0.999]}
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jax_build_optimizer(dict(cfg), max_grad_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in SHAPES]
    opt = build_optimizer(params, dict(cfg), clip)
    assert isinstance(opt.optimizer, torch.optim.AdamW)
    for step in range(6):
        grads = _grads(rng, scale=10.0 ** (step % 3 - 1))
        with torch.no_grad():  # each step from JAX's parameters: the moments carry, the rounding does not
            for p, k in zip(params, SHAPES):
                p.copy_(torch.from_numpy(np.asarray(jparams[k])))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in SHAPES])
        for p, k in zip(params, SHAPES):
            got, want = p.detach().numpy(), np.asarray(jparams[k])
            # 1e-7, or one float32 ulp where the two update orders round apart
            np.testing.assert_array_less(np.abs(got - want), 1e-7 + np.spacing(np.abs(want)) * 1.001,
                                         err_msg=f"{k} after step {step}")


def test_torch_adamw_decays_with_a_zero_gradient_and_saves_its_state():
    """A zero gradient still shrinks every weight by ``lr * weight_decay``
    of itself (optax's decayed-weights term), and the state round-trips."""
    cfg = {"_target_": "adam", "lr": 1e-2, "eps": 1e-5, "weight_decay": 0.5, "betas": [0.9, 0.999]}
    p = torch.nn.Parameter(torch.full((4,), 2.0))
    opt = build_optimizer([p], cfg, 100.0)
    opt.step([torch.zeros(4)])
    torch.testing.assert_close(p.detach(), torch.full((4,), 2.0 * (1 - 1e-2 * 0.5)))
    clone = build_optimizer([torch.nn.Parameter(p.detach().clone())], cfg, 100.0)
    clone.load_state_dict(opt.state_dict())
    assert float(clone.optimizer.state[clone.params[0]]["step"]) == 1.0


def test_torch_adamw_is_plain_adam_without_weight_decay():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = build_optimizer([p], {"_target_": "adam", "lr": 1e-3, "eps": 1e-8, "weight_decay": 0}, None)
    assert type(opt.optimizer) is torch.optim.Adam
    assert jax.tree_util.tree_structure(jax_build_optimizer({"lr": 1e-3, "weight_decay": 0}).init(jnp.zeros(3)))
