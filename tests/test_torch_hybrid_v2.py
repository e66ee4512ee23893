"""Dreamer V2's hybrid burst step against the JAX package's, on the CPU, at
the tiny size of ``tests/test_torch_rssm_v2_step.py`` (batch 2 x sequence
4, horizon 3), from the same converted parameters; and the retry of a burst
killed part way.

- The burst: ``make_train_step(..., ring=...)`` at the hybrid harness's
  ``grad_chunk`` (``round(replay_ratio x envs x train_every)``: 0.2 x 2 x 8
  = 3), one flush of ragged rows appended to a ring, 2 granted steps, the
  carry ``(cum,)`` starting at 1 with the hard target copy every 2 steps, so
  the burst's second step copies, as the coupled loop's step at ``cum`` 2
  does. JAX's draws are rebuilt from the burst key (``fold_in`` of the
  device index, ``split(G)``, per step ``k_env, k_start, k_grad``, then the
  step's own ``k_dyn, k_img``) and injected. Tolerances: the ring after the
  append bit for bit; the ten mean metrics within rtol 1e-5, atol 1e-6;
  every parameter within 1e-6 but for elements whose gradient was within
  float32 noise of zero at a step (below 1e-3 of its tensor's RMS), held
  within 2 lr (at most 0.1 % of a module's elements use that exemption).
- The retry: the harness's trainer thread dies (``ThreadKilled``) inside a
  burst, after the world model's update and before the actor's; the
  supervisor restarts it, the train state copy puts back every module
  (the target critic included), optimizer and the ring's generator, and
  the run ends bit-equal to an unfaulted one.

:func:`burst_parity` and :func:`retry_run` serve the other families' files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_make_train_step
from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    METRIC_NAMES,
    DreamerV2Learner,
    make_optimizers,
    make_train_step,
)
from sheeprl_tpu_torch.data.ring import effective_stage_buckets, make_blob_layouts, pack_burst_blob
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.utils.burst import HybridPlayerHarness, dreamer_ring_keys, dreamer_stage_sizes
from sheeprl_tpu_torch.utils.convert import dreamer_v2_state_from_jax
from tests.test_torch_rssm_v2_step import B, N_ACT, T, _txs, configs, jax_imagination_noise, jax_posterior_noise

CAP, E, GRANTED, ROWS = 24, 2, 2, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- shared by the families' files ---------------------------------------------


def ring_spec(cfg, train_every: int, with_is_first: bool, port_cfg, seq_len: int = T, batch: int = B):
    """The harness's ring spec at ``train_every`` on ``E`` envs and the
    port's and JAX's ring keys (the same ones)."""
    chunk = max(1, int(round(float(cfg.algo.replay_ratio) * E * train_every)))
    stage_max, stage_buckets = dreamer_stage_sizes(train_every, E, CAP)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": chunk, "seq_len": seq_len, "batch_size": batch,
            "stage_buckets": effective_stage_buckets(stage_buckets, stage_max), "stage_max": stage_max}
    keys = dreamer_ring_keys(port_cfg.spaces.obs, ["rgb"], ["state"], (N_ACT,), with_is_first=with_is_first)
    return spec, keys


def ring_values(keys, seed: int = 3):
    """A ring with episode boundaries, and the generator that
    :func:`blob_values` goes on drawing from."""
    rng = np.random.default_rng(seed)
    ring = {}
    for k, (shape, dtype) in keys.items():
        ring[k] = (rng.integers(0, 256, (CAP, E) + tuple(shape)).astype(np.uint8) if np.dtype(dtype) == np.uint8
                   else rng.normal(size=(CAP, E) + tuple(shape)).astype(np.float32))
    ring["actions"] = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (CAP, E))]
    ring["rewards"] = (rng.normal(size=(CAP, E, 1)) * 3).astype(np.float32)
    ring["terminated"] = (rng.random((CAP, E, 1)) < 0.05).astype(np.float32)
    if "is_first" in ring:
        ring["is_first"] = (rng.random((CAP, E, 1)) < 0.08).astype(np.float32)
    return ring, rng


def blob_values(ring, rng, chunk: int, bucket: int):
    """One flush's blob values: 5 ragged rows in ``bucket``, ``GRANTED`` of
    ``chunk`` steps granted."""
    staged = {k: np.zeros((bucket,) + v.shape[1:], v.dtype) for k, v in ring.items()}
    for k in staged:
        staged[k][:ROWS] = ring[k][rng.permutation(CAP)[:ROWS]]
    mask = np.zeros((bucket, E), np.int32)
    mask[:ROWS] = [[1, 1], [0, 1], [1, 1], [1, 0], [1, 1]]
    return {**staged, "__mask__": mask, "__pos__": np.array([9, 20], np.int32),
            "__valid_n__": np.array([CAP, 20], np.int32),
            "__validmask__": np.array([1.0] * GRANTED + [0.0] * (chunk - GRANTED), np.float32)}


def rebuild_draws(key, chunk: int, batch: int, noise_of):
    """JAX's draws of the ``GRANTED`` steps of a burst with ``key``:
    ``noise_of(k_grad)`` gives a step's noise from its own key."""
    env_idx, u, noise = [], [], []
    for k in jax.random.split(jax.random.fold_in(key, 0), chunk)[:GRANTED]:
        k_env, k_start, k_grad = jax.random.split(k, 3)
        env_idx.append(np.asarray(jax.random.randint(k_env, (batch,), 0, E)))
        u.append(np.array(jax.random.uniform(k_start, (batch,))))
        noise.append(noise_of(k_grad))
    return {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)), "noise": noise}


class GradFlags:
    """Wraps every optimizer's ``step`` to flag, per parameter, the elements
    whose gradient was below 1e-3 of its tensor's RMS at some step: Adam
    divides a gradient by its own scale, so from the second step on the
    float32 rounding of so small a one (a sum over thousands of terms of
    either sign) becomes a step difference past 1e-6, up to its lr."""

    def __init__(self, optimizers):
        self.flags, self.lr = {}, {}
        for opt in optimizers.values():
            lr = float(opt.optimizer.param_groups[0]["lr"])

            def step(grads, opt=opt, inner=opt.step, lr=lr):
                for p, g in zip(opt.params, grads):
                    flag = (g.abs() < 1e-3 * g.pow(2).mean().sqrt()).numpy()
                    self.flags[id(p)] = np.logical_or(self.flags.get(id(p), False), flag)
                    self.lr[id(p)] = lr
                return inner(grads)

            opt.step = step


def assert_params_match(modules, jax_state, before, flags: GradFlags, label=""):
    """Every parameter of ``modules`` ({name: module}) against JAX's state:
    within 1e-6, flagged elements within 2 lr, at most 0.1 % of a module's
    elements past 1e-6 by that exemption; each module moved."""
    for name, module in modules.items():
        want = jax_state[name]
        got = module.state_dict()
        assert set(got) == set(want), name
        params = dict(module.named_parameters())
        flagged = total = moved = 0
        for key, value in want.items():
            diff = np.abs(got[key].numpy() - value.numpy())
            p = params.get(key)
            free = np.broadcast_to(flags.flags.get(id(p), False), diff.shape) if p is not None else np.zeros(
                diff.shape, bool)
            lr = flags.lr.get(id(p), 0.0) if p is not None else 0.0
            assert (diff[~free] <= 1e-6).all(), f"{label} {name}.{key}: {diff[~free].max()}"
            assert (diff[free] <= 2 * lr).all(), f"{label} {name}.{key}"
            flagged, total = flagged + int((free & (diff > 1e-6)).sum()), total + diff.size
            moved += int(not np.array_equal(value.numpy(), before[name][key].numpy()))
        assert flagged <= 1e-3 * total, f"{label} {name}: {flagged} of {total} flagged"
        assert moved > 0, f"{label} the burst left every {name} parameter where it was"


def burst_parity(jax_burst, jax_carry, port_burst, port_carry, ring, values, bucket, keys, spec, key, noise_of):
    """One flush through each side's burst; returns ``(jax_out, port_out)``,
    each ``(carry, ring as numpy, metrics)``."""
    layouts = jax_make_blob_layouts(keys, E, spec["grad_chunk"], spec["stage_buckets"])
    blob = jax_pack(layouts[bucket], {**values, "__key__": np.asarray(key, np.uint32)})
    jcarry, jrb, jmetrics = jax_burst(jax_carry, {k: jnp.asarray(v) for k, v in ring.items()}, jnp.asarray(blob))
    draws = rebuild_draws(key, spec["grad_chunk"], spec["batch_size"], noise_of)
    rb = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    port_blob = pack_burst_blob(make_blob_layouts(keys, E, spec["grad_chunk"], spec["stage_buckets"])[bucket], values)
    pcarry, prb, pmetrics = port_burst(port_carry, rb, port_blob, None, draws)
    return ((jcarry, {k: np.asarray(v) for k, v in jrb.items()}, jmetrics),
            (pcarry, {k: v.numpy() for k, v in prb.items()}, pmetrics))


def retry_run(learner, cfg, keys, crash_at, carry, n_jobs: int = 3, crash_opt: str = "actor", seq_len: int = T,
              batch: int = B):
    """``n_jobs`` flushes of rows and grants through a
    :class:`HybridPlayerHarness` over ``learner``'s burst on the CPU; with
    ``crash_at`` the ``crash_at``-th call of ``optimizers[crash_opt].step``
    (after the world model's update of that step) raises ``ThreadKilled``
    once. Returns every module's and optimizer's state and the harness."""
    rng = np.random.default_rng(11)
    calls = [0]
    opt = learner.optimizers[crash_opt]
    inner = opt.step

    def step(grads):
        calls[0] += 1
        if calls[0] == crash_at:
            raise inject.ThreadKilled("killed inside a burst")
        return inner(grads)

    if crash_at:
        opt.step = step
    sub = learner.player_modules()
    hp = HybridPlayerHarness(
        cfg, ring_keys=keys, capacity=CAP, seq_len=seq_len, batch_size=batch, policy_steps_per_iter=E,
        make_burst_fn=learner.burst, player_card=list(sub.parameters()), player_host=[p.detach().clone()
                                                                                      for p in sub.parameters()],
        carry=carry, device="cpu", train_modules=learner.train_modules, optimizers=list(learner.optimizers.values()),
        metric_names=learner.burst_metric_names,
    )
    try:
        for _ in range(n_jobs):
            for _ in range(hp.grad_chunk // E + seq_len):
                row = {k: (rng.integers(0, 256, (1, E) + shape).astype(np.uint8) if dt == np.uint8
                           else rng.normal(size=(1, E) + shape).astype(np.float32)) for k, (shape, dt) in keys.items()}
                hp.stage_step(row)
            hp.grant(hp.grad_chunk)
            hp.flush()
        carry = hp.finish()
    finally:
        opt.step = inner
    restarts = hp.trainer.supervisor.snapshot()["burst-trainer"]["restarts"]
    modules = {f"m{i}": {k: v.clone() for k, v in m.state_dict().items()} for i, m in enumerate(learner.train_modules)}
    opts = {n: [t.clone() for t in o.state_tensors()] for n, o in learner.optimizers.items()}
    return {"modules": modules, "opts": opts, "carry": carry, "restarts": restarts, "hp": hp,
            "gen": hp.generator.get_state()}


def assert_same_run(a, b):
    for name in a["modules"]:
        for k, v in a["modules"][name].items():
            assert torch.equal(v, b["modules"][name][k]), f"{name}.{k}"
    for name in a["opts"]:
        for x, y in zip(a["opts"][name], b["opts"][name]):
            assert torch.equal(x, y), name
    assert torch.equal(a["gen"], b["gen"])


# -- Dreamer V2 ---------------------------------------------------------------------

FREQ = ["algo.critic.per_rank_target_network_update_freq=2"]


@pytest.fixture(scope="module")
def burst():
    cfg, port_cfg, obs_space = configs(False, FREQ)
    fabric = Fabric(devices=1, accelerator="cpu")
    world_model, actor, critic, params, _ = jax_build_agent(fabric, (N_ACT,), False, cfg, obs_space)
    before = jax.tree.map(np.array, params)
    txs = _txs(cfg)
    opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"])}
    spec, keys = ring_spec(cfg, 8, True, port_cfg)
    ring, rng = ring_values(keys)
    bucket = spec["stage_buckets"][0]
    values = blob_values(ring, rng, spec["grad_chunk"], bucket)
    jax_burst = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACT,), False, txs,
                                    ring={**spec, "ring_keys": keys})
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)

    def noise_of(k_grad):
        k_dyn, k_img = jax.random.split(k_grad)
        return {"posterior": jax_posterior_noise(k_dyn, S, D),
                **jax_imagination_noise(k_img, S, D, T * B, "discrete")}

    state = dreamer_v2_state_from_jax(before)
    modules = dict(zip(("world_model", "actor", "critic", "target_critic"), build_agent(port_cfg, "cpu", state)))
    optimizers = make_optimizers(port_cfg, modules["world_model"], modules["actor"], modules["critic"])
    flags = GradFlags(optimizers)
    port_burst = make_train_step(*modules.values(), optimizers, port_cfg, ring={**spec, "ring_keys": keys})
    # the critic's copy at cum 2 (the burst's second step) is what the target ends as
    critic_after_first = {}
    inner_critic = optimizers["critic"].step

    def critic_step(grads):
        out = inner_critic(grads)
        if not critic_after_first:
            critic_after_first.update({k: v.clone() for k, v in modules["critic"].state_dict().items()})
        return out

    optimizers["critic"].step = critic_step
    jax_out, port_out = burst_parity(jax_burst, (params, opts, jnp.int32(1)), port_burst, (1,), ring, values, bucket,
                                     keys, spec, jax.random.PRNGKey(33), noise_of)
    return {"spec": spec, "jax": jax_out, "port": port_out, "modules": modules, "flags": flags,
            "before": state, "critic_after_first": critic_after_first}


def test_torch_hybrid_v2_spec_is_the_harness_spec(burst):
    assert burst["spec"]["grad_chunk"] == 3 and burst["spec"]["stage_buckets"] == (12, 20, 24)


def test_torch_hybrid_v2_burst_appends_the_ring_like_jax(burst):
    for k, want in burst["jax"][1].items():
        np.testing.assert_array_equal(burst["port"][1][k], want, err_msg=k)


def test_torch_hybrid_v2_burst_counts_and_copies_inside(burst):
    """The carry ends at ``cum`` 3 on both sides; the target critic is the
    critic after the burst's first step: the copy at ``cum`` 2 happened
    inside the burst, before its second step."""
    assert burst["port"][0] == (3,) and int(burst["jax"][0][2]) == 3
    target = burst["modules"]["target_critic"].state_dict()
    for k, v in burst["critic_after_first"].items():
        assert torch.equal(target[k], v), k


@pytest.mark.parametrize("index", range(len(METRIC_NAMES)), ids=[n.split("/")[1] for n in METRIC_NAMES])
def test_torch_hybrid_v2_burst_metric_matches_jax(burst, index):
    got, want = float(burst["port"][2][index]), float(burst["jax"][2][index])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=METRIC_NAMES[index])


def test_torch_hybrid_v2_burst_parameters_match_jax(burst):
    jax_params = dreamer_v2_state_from_jax(jax.tree.map(np.asarray, burst["jax"][0][0]))
    assert_params_match(burst["modules"], jax_params, burst["before"], burst["flags"], "v2")


@pytest.fixture(scope="module")
def retried():
    cfg, port_cfg, _ = configs(False, FREQ)
    port_cfg.algo["hybrid_player"] = {"train_every": 8}
    port_cfg["fault"] = {"supervisor": {"backoff": 0, "max_restarts": 2}}
    _, keys = ring_spec(cfg, 8, True, port_cfg)
    runs = {}
    for crash_at in (0, 4):  # the 4th actor update: the 2nd burst's first step, after its world-model update
        learner = DreamerV2Learner(port_cfg, torch.device("cpu"), None)
        runs[crash_at] = retry_run(learner, port_cfg, keys, crash_at, learner.burst_carry)
    return runs


def test_torch_hybrid_v2_retry_ends_bit_equal_to_the_unfaulted_run(retried):
    clean, faulted = retried[0], retried[4]
    assert clean["restarts"] == 0 and faulted["restarts"] == 1
    assert faulted["hp"].trainer._rollback.restores == 1
    assert clean["hp"].gradient_steps == faulted["hp"].gradient_steps == 3 * clean["hp"].grad_chunk == 9
    assert clean["carry"] == faulted["carry"] == (9,)
    assert_same_run(clean, faulted)
