"""The guarded SAC updates of the port against the JAX package's
``guard=True`` steps, on the CPU, with NaN rewards in the rows they draw.

The sizes, rings and draws of ``test_torch_sac_update.py`` (hidden 32,
batch 16, 2 critics, a 64 x 2 ring holding 23 rows with random priorities
and ``max_p`` 3, one staged row appended, 2 gradient steps fed JAX's own
draws):

- the resident dispatch with PER: the reward of a row that a step draws is
  NaN, so that step's critic loss and gradients are not finite and the
  guard undoes it on both sides: the parameters (target critics included),
  the three Adams, the drawn leaves' priorities and ``max_p``; with every
  reward NaN both steps are undone and the tree, ``max_p`` and every
  parameter are bit-equal to before the steps, so the next draw sees the
  tree a control that never took the poisoned step sees;
- the host path's ``make_train_step`` on a ``(2, 16)`` sample with a NaN
  reward in its first step.

Tolerances as there: the skipped count exact; parameters, the sum-tree and
``max_p`` within 1e-5 of JAX's (float32 sums in another order); what a
fully undone dispatch leaves, bit-equal to before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac.sac import make_resident_train_step as jax_resident_step
from sheeprl_tpu.algos.sac.sac import make_train_step as jax_train_step
from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step, make_train_step
from sheeprl_tpu_torch.replay import sumtree as st
from tests.test_torch_sac_update import (
    ACT,
    BATCH,
    FILLED,
    G,
    N_ENVS,
    _compare_params,
    _filled_jax_ring,
    _jax_resident_draws,
    _jax_setup,
    _port_ring,
    _port_setup,
    _row,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_after_append(pdrb, pos: int):
    """The tree the dispatch's first draw descends: the row appended at
    ``pos`` has fresh leaves at ``max_p``."""
    fresh = torch.arange(pos * N_ENVS, (pos + 1) * N_ENVS)
    return st.update(pdrb.tree.clone(), fresh, pdrb.max_p.expand(fresh.shape[0]))


@pytest.mark.parametrize("poison", ["first-draw", "every-row"])
def test_torch_fault_sac_resident_per_dispatch_matches_jax(poison):
    rng = np.random.default_rng(5)
    cfg, fabric, jagent, params, txs, opts = _jax_setup(True)
    jdrb = _filled_jax_ring(fabric, True, rng)
    pcfg, agent, optimizers = _port_setup(params)
    pdrb = _port_ring(jdrb, True)
    row = _row(rng)
    beta = 0.55
    key = jnp.asarray(np.asarray(jdrb.state["key"]))
    draws = _jax_resident_draws(key, True, FILLED + 1)
    tree = _tree_after_append(pdrb, FILLED)
    if poison == "first-draw":
        leaf = int(st.sample(tree, draws["u"][0])[0])
        rows, envs = np.array([leaf // N_ENVS]), np.array([leaf % N_ENVS])
    else:
        rows, envs = np.divmod(np.arange(FILLED * N_ENVS), N_ENVS)
        row["rewards"][:] = np.nan
    jdrb.state["storage"]["rewards"] = jdrb.state["storage"]["rewards"].at[rows, envs].set(jnp.nan)
    pdrb.storage["rewards"][torch.from_numpy(rows), torch.from_numpy(envs)] = float("nan")
    pdrb.add(row)
    job = pdrb.make_job()
    assert (job.pos, job.count, job.valid) == (FILLED, 1, FILLED + 1)
    before = {k: v.clone() for k, v in agent.state_dict().items()}

    jdrb.add(row)
    blob = jdrb.make_job({"__flags__": np.ones(G, np.float32), "__valid__": np.ones(G, np.float32),
                          "__beta__": np.float32(beta)})
    step = jax_resident_step(jagent, *txs, cfg, fabric.mesh, jdrb, G, guard=True, donate=False)
    p_new, _, _, _, state, _, _, _, skipped = step(params, opts[0], opts[1], opts[2], jdrb.state, blob)

    train = make_resident_train_step(agent, optimizers, pcfg, pdrb, guard=True)
    _, port_skipped = train(job, [1.0, 1.0], beta, draws=draws)

    jax_skipped = float(np.sum(np.asarray(skipped)))
    assert jax_skipped == float(port_skipped) >= 1.0
    _compare_params(agent, p_new)
    np.testing.assert_allclose(pdrb.tree.numpy(), np.asarray(state["tree"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(pdrb.max_p), float(state["max_p"]), rtol=1e-5)
    assert torch.isfinite(pdrb.tree).all() and torch.isfinite(pdrb.max_p)
    if poison == "every-row":
        assert float(port_skipped) == G
        assert torch.equal(pdrb.tree, tree) and float(pdrb.max_p) == 3.0
        assert all(torch.equal(before[k], v) for k, v in agent.state_dict().items())
        assert {int(s["step"]) for opt in optimizers for s in opt.optimizer.state.values()} == {0}


def test_torch_fault_sac_resident_draws_from_the_restored_tree():
    """After a dispatch whose every step was undone, the next draw's leaves
    equal those of a control ring that never took the poisoned steps."""
    rng = np.random.default_rng(5)
    _, fabric, _, params, _, _ = _jax_setup(True)
    pcfg, agent, optimizers = _port_setup(params)
    jdrb = _filled_jax_ring(fabric, True, rng)
    pdrb, control = _port_ring(jdrb, True), _port_ring(jdrb, True)
    row = _row(rng)
    for drb in (pdrb, control):
        drb.add(row)
        drb.append(drb.make_job())
    pdrb.storage["rewards"].fill_(float("nan"))
    train = make_resident_train_step(agent, optimizers, pcfg, pdrb, guard=True)
    job = pdrb.make_job()
    _, skipped = train(job, [1.0, 1.0], 0.55, draws=_jax_resident_draws(jax.random.PRNGKey(1), True, job.valid))
    assert float(skipped) == G
    u = torch.from_numpy(np.random.default_rng(2).uniform(size=BATCH).astype(np.float32))
    assert torch.equal(st.sample(pdrb.tree, u), st.sample(control.tree, u))
    assert torch.equal(pdrb.tree, control.tree) and torch.equal(pdrb.max_p, control.max_p)


def test_torch_fault_sac_host_train_step_matches_jax():
    rng = np.random.default_rng(8)
    cfg, fabric, jagent, params, txs, opts = _jax_setup(False)
    pcfg, agent, optimizers = _port_setup(params)
    data = {k: v.reshape(G, BATCH, -1) for k, v in _row(rng, G * BATCH // N_ENVS).items()}
    data["rewards"][0, 3] = np.nan  # the first step's batch
    key = jax.random.PRNGKey(11)
    step = jax_train_step(jagent, *txs, cfg, fabric.mesh, donate=False, guard=True)
    p_new, _, _, _, _, _, _, skipped = step(params, opts[0], opts[1], opts[2], data, key, jnp.float32(1.0))

    noise = {"next": [], "actor": []}
    for k in jax.random.split(jax.random.fold_in(key, 0), G):
        k_next, k_actor = jax.random.split(k)
        noise["next"].append(np.asarray(jax.random.normal(k_next, (BATCH, ACT))))
        noise["actor"].append(np.asarray(jax.random.normal(k_actor, (BATCH, ACT))))
    noise = {k: torch.from_numpy(np.stack(v)) for k, v in noise.items()}
    train = make_train_step(agent, optimizers, pcfg, guard=True)
    _, port_skipped = train({k: torch.from_numpy(v) for k, v in data.items()}, True, noise=noise)
    assert float(np.sum(np.asarray(skipped))) == float(port_skipped) == 1.0
    _compare_params(agent, p_new)
    assert {int(s["step"]) for opt in optimizers for s in opt.optimizer.state.values()} == {G - 1}
