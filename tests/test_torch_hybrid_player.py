"""The hybrid host player's machinery (``sheeprl_tpu_torch/utils/burst.py``)
against the JAX package's (``sheeprl_tpu/utils/burst.py``), on the CPU.

- ``resolve_hybrid_player``: both agree on every value of ``enabled`` on
  both kinds of device.
- ``BurstRunner.flush``: the same staged steps, ragged reset rows,
  ``patch_last`` edits and grants go through JAX's runner (its burst
  function stubbed to record the jobs) and the port's. Each flush's blob
  holds the same bytes, segment by segment (JAX's ``__key__`` excepted: the
  port's draws come from the ring's generator), the same granted chunk and
  the same heads; then each side's real burst program (a stub gradient step)
  appends its blobs to a ring, and the rings are equal bit for bit.
- ``TrainerThread``: a ``ThreadKilled`` at ``burst.trainer.step`` (before
  the step) and a crash inside a step (after it has updated the modules in
  place) each end, after the supervisor's restart, at the parameters of an
  unfaulted run with the same draws, bit for bit.
- ``HostSnapshot``: a pull's copy is the card's tensors rounded to the wire
  dtype; a packed snapshot is unchanged by later in-place updates.
- The Dreamer V2/V1 and P2E exploration presets resolve ``enabled`` as
  JAX's do (``true`` on, ``auto`` on for the card only, ``false`` off); the
  finetuning presets compose under ``true`` and their learners train
  coupled.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.data.ring import build_burst_train_step as jax_build_burst
from sheeprl_tpu.utils.burst import BurstRunner as JaxBurstRunner
from sheeprl_tpu.utils.burst import dreamer_stage_sizes as jax_dreamer_stage_sizes
from sheeprl_tpu.utils.utils import resolve_hybrid_player as jax_resolve
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.data.ring import build_burst_train_step
from sheeprl_tpu_torch.fault import inject
from sheeprl_tpu_torch.optim import build_optimizer
from sheeprl_tpu_torch.utils.burst import (
    BurstRunner,
    HostSnapshot,
    TrainerThread,
    TrainStateCopy,
    dreamer_stage_sizes,
)
from sheeprl_tpu_torch.utils.utils import resolve_hybrid_player

CAP, E, T, B, TRAIN_EVERY = 24, 2, 4, 2, 3
GRAD_CHUNK = E * TRAIN_EVERY  # replay ratio 1
RING_KEYS = {
    "rgb": ((3, 2, 2), np.dtype(np.uint8)),
    "state": ((3,), np.dtype(np.float32)),
    "actions": ((2,), np.dtype(np.float32)),
    "rewards": ((1,), np.dtype(np.float32)),
    "terminated": ((1,), np.dtype(np.float32)),
    "is_first": ((1,), np.dtype(np.float32)),
}


class _Mesh:
    """What ``resolve_hybrid_player`` reads of a JAX mesh."""

    def __init__(self, platform):
        self.devices = np.array([type("D", (), {"platform": platform})()])


@pytest.mark.parametrize("enabled", ["auto", "AUTO", "true", "True", "false", "FALSE", True, False, "other", None])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_torch_hybrid_player_resolve_matches_jax(enabled, device):
    hp_cfg = {} if enabled is None else {"enabled": enabled}
    want = jax_resolve(hp_cfg, _Mesh("cpu" if device == "cpu" else "tpu"))
    assert resolve_hybrid_player(hp_cfg, torch.device(device)) is want
    assert resolve_hybrid_player(hp_cfg, device) is want


def test_torch_hybrid_player_stage_sizes_match_jax():
    for args in ((16, 1, 100000), (16, 4, 100000), (3, 2, 24), (64, 1, 50)):
        assert dreamer_stage_sizes(*args) == jax_dreamer_stage_sizes(*args)


# -- BurstRunner.flush ------------------------------------------------------


def _step_data(rng):
    return {
        "rgb": rng.integers(0, 256, (1, E, 3, 2, 2)).astype(np.uint8),
        "state": rng.normal(size=(1, E, 3)).astype(np.float32),
        "actions": rng.normal(size=(1, E, 2)).astype(np.float32),
        "rewards": rng.normal(size=(1, E, 1)).astype(np.float32),
        "terminated": (rng.random((1, E, 1)) < 0.1).astype(np.float32),
        "is_first": (rng.random((1, E, 1)) < 0.1).astype(np.float32),
    }


def _drive(rng, jax_runner, port_runner, steps=48):
    """The same staging and grants through both runners; returns the
    chunks each flush granted."""
    chunks, backlog = [], 0
    key = jax.random.PRNGKey(3)
    for it in range(steps):
        step = _step_data(rng)
        jax_runner.stage_step(step)
        port_runner.stage_step(step)
        if rng.random() < 0.25:
            done = sorted(rng.choice(E, size=int(rng.integers(1, E + 1)), replace=False).tolist())
            reset = {k: v[:, done] for k, v in _step_data(rng).items()}
            jax_runner.stage_reset(reset, done)
            port_runner.stage_reset(reset, done)
        if rng.random() < 0.2:
            env = int(rng.integers(0, E))
            jax_runner.patch_last(env, {"terminated": 0.0, "is_first": 0.0})
            port_runner.patch_last(env, {"terminated": 0.0, "is_first": 0.0})
        if it == 1:  # a first grant before any env holds a window, as Ratio's first call can give
            backlog += 2 * GRAD_CHUNK
        elif it > 1 and not 20 <= it < 34:  # a quiet stretch fills the staging rows to a larger bucket
            backlog += int(rng.integers(0, 2 * E))
        while backlog >= GRAD_CHUNK or port_runner.staging_full():
            assert jax_runner.staging_full() == port_runner.staging_full()
            key, sub = jax.random.split(key)
            got, want = port_runner.flush(backlog), jax_runner.flush(sub, backlog)
            assert got == want
            np.testing.assert_array_equal(port_runner.dev_pos, jax_runner.dev_pos)
            np.testing.assert_array_equal(port_runner.dev_valid, jax_runner.dev_valid)
            chunks.append(got)
            backlog -= got
            if got == 0 or backlog < GRAD_CHUNK:
                break
    return chunks


@pytest.fixture(scope="module")
def flushed():
    stage_max, buckets = dreamer_stage_sizes(TRAIN_EVERY, E, CAP)
    jax_keys = {k: (shape, dtype) for k, (shape, dtype) in RING_KEYS.items()}
    jax_layouts = jax_make_blob_layouts(jax_keys, E, GRAD_CHUNK, (*buckets, stage_max))
    jax_blobs, port_blobs = [], []

    def jax_stub(carry, rb, blob):
        jax_blobs.append(np.asarray(blob).copy())
        return carry, rb, None

    def port_stub(carry, rb, blob, generator=None):
        port_blobs.append(blob.clone())  # the slab goes back to the pool after the job
        return carry, rb, None

    jax_runner = JaxBurstRunner(jax_stub, 0, {}, jax_keys, n_envs=E, capacity=CAP, grad_chunk=GRAD_CHUNK,
                                stage_max=stage_max, seq_len=T, stage_buckets=buckets, blob_layouts=jax_layouts,
                                supervisor_cfg={"backoff": 0})
    port_runner = BurstRunner(port_stub, 0, {}, RING_KEYS, n_envs=E, capacity=CAP, grad_chunk=GRAD_CHUNK,
                              stage_max=stage_max, seq_len=T, stage_buckets=buckets, supervisor_cfg={"backoff": 0})
    try:
        chunks = _drive(np.random.default_rng(7), jax_runner, port_runner)
    finally:
        jax_runner.close()
        port_runner.close()
    assert (port_runner.dev_valid == CAP).all()  # every env's ring filled and wrapped
    return {"chunks": chunks, "jax": jax_blobs, "port": port_blobs, "jax_layouts": jax_layouts,
            "port_layouts": port_runner._layouts, "stage_max": stage_max, "buckets": buckets}


def test_torch_hybrid_player_flush_blobs_match_jax(flushed):
    assert len(flushed["jax"]) == len(flushed["port"]) == len(flushed["chunks"]) >= 5
    assert any(c == GRAD_CHUNK for c in flushed["chunks"]) and flushed["chunks"][0] == 0  # held until a window fits
    sizes = set()
    for jblob, pblob in zip(flushed["jax"], flushed["port"]):
        jl = next(lay for lay in flushed["jax_layouts"].values() if lay.nbytes == jblob.size)
        pl = next(lay for lay in flushed["port_layouts"].values() if lay.nbytes == pblob.numel())
        jseg = {name: (off, np.prod(shape) * np.dtype(dt).itemsize) for name, off, shape, dt in jl.segments}
        pseg = {name: (off, np.prod(shape) * np.dtype(dt).itemsize) for name, off, shape, dt in pl.segments}
        assert set(jseg) - set(pseg) == {"__key__"} and set(pseg) <= set(jseg)
        raw = pblob.numpy()
        for name, (off, n) in pseg.items():
            joff, jn = jseg[name]
            assert n == jn, name
            np.testing.assert_array_equal(raw[off:off + n], jblob[joff:joff + jn], err_msg=name)
        sizes.add(pblob.numel())
    assert len(sizes) >= 2  # more than one bucket was used


def test_torch_hybrid_player_flushed_ring_matches_jax(flushed):
    """Each side's own burst program appends its blobs (a stub gradient
    step: only the ring is compared); the rings equal bit for bit."""
    buckets = tuple(sorted(set(flushed["buckets"]) | {flushed["stage_max"]}))
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": GRAD_CHUNK, "seq_len": T, "batch_size": B,
            "ring_keys": RING_KEYS, "stage_buckets": buckets, "stage_max": flushed["stage_max"]}
    fabric = Fabric(devices=1, accelerator="cpu")
    jax_burst = jax_build_burst(lambda carry, xs: (carry, (jnp.float32(0),)), fabric.mesh, spec)
    port_burst = build_burst_train_step(lambda carry, xs: (carry, torch.zeros(10)), spec, lambda g: None)
    jax_rb = {k: jnp.zeros((CAP, E) + shape, dtype) for k, (shape, dtype) in RING_KEYS.items()}
    port_rb = {k: torch.from_numpy(np.zeros((CAP, E) + shape, dtype)) for k, (shape, dtype) in RING_KEYS.items()}
    carry, gen = 0, torch.Generator().manual_seed(0)
    for jblob, pblob in zip(flushed["jax"], flushed["port"]):
        _, jax_rb, _ = jax_burst(jnp.int32(0), jax_rb, jnp.asarray(jblob))
        carry, port_rb, _ = port_burst(carry, port_rb, pblob, gen)
    for k in RING_KEYS:
        np.testing.assert_array_equal(port_rb[k].numpy(), np.asarray(jax_rb[k]), err_msg=k)


# -- TrainerThread ------------------------------------------------------------

ADAM = {"_target_": "adam", "lr": 0.01, "eps": 1e-8, "weight_decay": 0, "betas": [0.9, 0.999]}


def _train_setup():
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 3)
    opt = build_optimizer(net.parameters(), dotdict(ADAM))
    gen = torch.Generator().manual_seed(11)
    return net, opt, gen


def _trainer_run(crash=None, rollback=True):
    """Five jobs through a TrainerThread; ``crash`` arms ``burst.trainer.step``
    (``"point"``) or raises ThreadKilled inside the third job's step, after
    its first in-place update (``"inside"``)."""
    net, opt, gen = _train_setup()
    died = []

    def step(carry, job):
        x = torch.full((5, 4), float(job))
        for i in range(2):
            noise = torch.randn((5, 3), generator=gen)
            loss = ((net(x) - noise) ** 2).mean()
            opt.step(torch.autograd.grad(loss, list(net.parameters())))
            if crash == "inside" and job == 3 and i == 0 and not died:
                died.append(True)
                raise inject.ThreadKilled("crash inside the step")
        return carry + 1, loss.detach()

    inject.reset()
    if crash == "point":
        inject.arm("burst.trainer.step", "kill-thread", at=3)
    state = TrainStateCopy([net], [opt], [gen]) if rollback else None
    trainer = TrainerThread(step, 0, supervisor_cfg={"backoff": 0, "max_restarts": 2}, rollback=state)
    try:
        for job in range(1, 6):
            trainer.submit(job)
        carry = trainer.close()
    finally:
        inject.reset()
    restarts = trainer.supervisor.snapshot()["burst-trainer"]["restarts"]
    return carry, [p.detach().clone() for p in net.parameters()], restarts, state


@pytest.mark.parametrize("crash", ["point", "inside"])
def test_torch_hybrid_player_trainer_restart_matches_unfaulted_run(crash):
    carry, want, restarts, _ = _trainer_run()
    assert carry == 5 and restarts == 0
    carry, got, restarts, state = _trainer_run(crash)
    assert carry == 5 and restarts == 1
    assert state.restores == (1 if crash == "inside" else 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_torch_hybrid_player_trainer_without_rollback_double_applies():
    """What the rollback prevents: a retried burst on the state its dead try
    left behind ends elsewhere."""
    _, want, _, _ = _trainer_run()
    _, got, restarts, _ = _trainer_run("inside", rollback=False)
    assert restarts == 1 and any(not torch.equal(g, w) for g, w in zip(got, want))


def test_torch_hybrid_player_train_state_copy_restores_modules_optimizer_and_generator():
    net, opt, gen = _train_setup()
    loss = net(torch.randn((2, 4), generator=gen)).sum()
    opt.step(torch.autograd.grad(loss, list(net.parameters())))  # a state with moments and a step count
    before = [t.clone() for t in [*net.parameters(), *opt.state_tensors()]]
    state = TrainStateCopy([net], [opt], [gen])
    state.snapshot()
    draw = torch.randn(3, generator=gen)
    loss = net(torch.randn((2, 4), generator=gen)).sum()
    opt.step(torch.autograd.grad(loss, list(net.parameters())))
    assert not all(torch.equal(a, b) for a, b in zip([*net.parameters(), *opt.state_tensors()], before))
    state.restore()
    assert all(torch.equal(a, b) for a, b in zip([*net.parameters(), *opt.state_tensors()], before))
    assert torch.equal(torch.randn(3, generator=gen), draw)


# -- HostSnapshot -----------------------------------------------------------


@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32])
def test_torch_hybrid_player_snapshot_pull_and_isolation(wire):
    torch.manual_seed(1)
    card = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.LayerNorm(7))
    host = copy.deepcopy(card)
    with torch.no_grad():
        for p in host.parameters():
            p.zero_()
    snap = HostSnapshot(list(card.parameters()), list(host.parameters()), wire)
    assert snap.nbytes == sum(p.numel() for p in card.parameters()) * (2 if wire == torch.bfloat16 else 4)
    snap.pull()
    for c, h in zip(card.parameters(), host.parameters()):
        assert torch.equal(h, c.detach().to(wire).float())
    packed = [p.detach().clone() for p in card.parameters()]
    assert snap.refresh_async(version=7)
    with torch.no_grad():  # an in-place update after the snapshot was packed
        for p in card.parameters():
            p.add_(1.0)
    assert snap.poll() and snap.host_version == 7 and not snap.poll()
    for c, h in zip(packed, host.parameters()):
        assert torch.equal(h, c.to(wire).float())


# -- the Dreamer V2/V1 and P2E families' switch ---------------------------------

@pytest.mark.parametrize("preset_name", ["dreamer_v2_atari_dummy", "dreamer_v1_atari_dummy",
                                         "p2e_dv3_exploration_atari_dummy", "p2e_dv2_exploration_atari_dummy",
                                         "p2e_dv1_exploration_atari_dummy"],
                         ids=["v2", "v1", "explore_v3", "explore_v2", "explore_v1"])
def test_torch_hybrid_player_families_resolve_as_jax(preset_name):
    """``true`` composes and resolves on (the CPU too, as JAX's); ``auto``
    (the preset's) on for the card and off for the CPU; ``false`` off."""
    cfg = cli.compose_run_config([f"preset={preset_name}", "algo.hybrid_player.enabled=true"])
    assert resolve_hybrid_player(cfg.algo.hybrid_player, "cpu") and resolve_hybrid_player(cfg.algo.hybrid_player,
                                                                                         "cuda")
    cfg = cli.compose_run_config([f"preset={preset_name}"])
    assert cfg.algo.hybrid_player.enabled == "auto"
    assert resolve_hybrid_player(cfg.algo.hybrid_player, "cuda") and not resolve_hybrid_player(cfg.algo.hybrid_player,
                                                                                             "cpu")
    cfg = cli.compose_run_config([f"preset={preset_name}", "algo.hybrid_player.enabled=false"])
    assert not resolve_hybrid_player(cfg.algo.hybrid_player, "cuda")


@pytest.mark.parametrize("phase", ["p2e_dv3_finetuning", "p2e_dv2_finetuning", "p2e_dv1_finetuning"],
                         ids=["v3", "v2", "v1"])
def test_torch_hybrid_player_finetuning_composes_under_true_and_trains_coupled(phase):
    import importlib

    cfg = cli.compose_run_config([f"preset={phase}_atari_dummy", "algo.hybrid_player.enabled=true",
                                  "checkpoint.exploration_ckpt_path=x.ckpt"])
    assert str(cfg.algo.hybrid_player.enabled).lower() == "true"
    family = phase.split("_")[1]
    learner = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_{family}.{phase}").FinetuningLearner
    assert learner.hybrid is False  # JAX's finetuning loops never read the key


def test_torch_hybrid_player_presets_follow_jax_exps():
    from sheeprl_tpu_torch.config import preset

    for name in ("dreamer_v3_100k_atari_dummy", "dreamer_v3_S_atari100k", "dreamer_v3_continuous_dummy",
                 "dreamer_v2_atari_dummy", "dreamer_v2_ms_pacman_dummy", "dreamer_v1_atari_dummy",
                 "p2e_dv1_exploration_atari_dummy", "p2e_dv2_exploration_atari_dummy",
                 "p2e_dv3_exploration_atari_dummy"):
        assert preset(name).algo.hybrid_player == {"enabled": "auto", "train_every": 16, "snapshot_every": 4}
    assert preset("sac").algo.hybrid_player == {"enabled": "auto", "refresh_every": 64}
    for name in ("dreamer_v3_100k_atari_dummy_resident", "sac_per", "dreamer_sebulba_atari_dummy", "sac_sebulba",
                 "sac_sebulba_per"):
        assert preset(name).algo.hybrid_player.enabled is False
