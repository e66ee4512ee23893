"""The port's device sequence ring (``replay/driver.py``'s ``SequenceRingDriver``,
``data/ring.py``'s ``build_burst_train_step``, ``utils/burst.py``,
``replay/device_buffer.py``'s ``restore_host_env_buffer``) against the JAX
package's, on the CPU.

- The driver's host accounting over one staged stream of 3 envs with
  ragged resets, grants and drains: every flush's bucket, write masks,
  heads, valid counts and granted-step mask, the backlog, the gate and the
  step counters equal JAX's exactly (both drivers get a stub burst that
  records its blob).
- One burst (append + granted steps) through ``build_burst_train_step`` on
  both sides with a probe step that returns integer checksums of its window
  (exact in float32): the ring after the append equal bit for bit, the
  windows JAX's (its uniforms rebuilt from its keys) and the metrics'
  average over the granted steps equal.
- The crossovers: a sequence snapshot restored into host per-env buffers,
  and host per-env buffers mirrored into a new ring, equal JAX's; the
  checkpoint round trip restores the ring, heads and generator exactly;
  a JAX snapshot converts (its key stays behind).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.data.ring import build_burst_train_step as jax_build_burst
from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.data.ring import ring_append_rows as jax_ring_append_rows
from sheeprl_tpu.data.ring import ring_sample_windows as jax_ring_sample_windows
from sheeprl_tpu.data.ring import unpack_burst_blob as jax_unpack
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu.replay import DeviceReplayState as JaxDeviceReplayState
from sheeprl_tpu.replay import SequenceRingDriver as JaxSequenceRingDriver
from sheeprl_tpu.replay import restore_host_env_buffer as jax_restore_host_env_buffer
from sheeprl_tpu.utils.burst import init_device_ring as jax_init_device_ring
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.ring import (
    build_burst_train_step,
    make_blob_layouts,
    pack_burst_blob,
    ring_sample_windows,
    unpack_burst_blob,
)
from sheeprl_tpu_torch.replay import DeviceReplayState, SequenceRingDriver, restore_host_env_buffer
from sheeprl_tpu_torch.utils.burst import init_device_ring
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.convert import sequence_ring_from_jax

CAP, E, T, B = 16, 3, 4, 3
KEYS = {
    "rgb": ((2, 2, 3), np.uint8),
    "actions": ((2,), np.float32),
    "rewards": ((1,), np.float32),
    "terminated": ((1,), np.float32),
    "is_first": ((1,), np.float32),
}
JAX_KEYS = {k: (s, jnp.dtype(d)) for k, (s, d) in KEYS.items()}


@pytest.fixture(scope="module")
def fabric():
    return Fabric(devices=1, accelerator="cpu")


def _step_data(rng, n=E):
    data = {k: rng.integers(0, 200, (1, n) + s).astype(d) for k, (s, d) in KEYS.items()}
    data["is_first"] = (rng.random((1, n, 1)) < 0.2).astype(np.float32)
    return data


def _stream(rng, steps):
    """``(step data, done envs, grant)`` per env step."""
    out = []
    for t in range(steps):
        done = [i for i in range(E) if rng.random() < 0.15]
        out.append((_step_data(rng), done, int(rng.integers(0, 4)) if t >= 5 else 0))
    return out


class _Recorder:
    def __init__(self):
        self.blobs = []

    def __call__(self, ring):
        def burst(carry, rb, blob, *args):
            self.blobs.append(np.asarray(blob).copy())
            return carry, rb, "metrics"

        return burst


def test_torch_seq_ring_driver_host_accounting_matches_jax(fabric):
    """The same stream through both drivers (grad_chunk 2, seq_len 4): every
    flush's blob segments (``patch_last`` edits included), and after it the
    heads, valid counts, backlog and counters; the drains of ``pump``; the
    gate holding grants until every env has a window."""
    jrec, prec = _Recorder(), _Recorder()
    jd = JaxSequenceRingDriver(fabric, JAX_KEYS, CAP, E, T, B, 2, jrec, seed=3)
    pd = SequenceRingDriver(KEYS, CAP, E, T, B, 2, prec, seed=3)
    rng = np.random.default_rng(0)
    trained = 0
    for step, done, grant in _stream(rng, 60):
        reset = {k: v[:, done] for k, v in _step_data(rng).items()}
        for d in (jd, pd):
            d.stage_step(step)
            if grant == 3:  # the truncation patch of an env restart, on the newest staged row
                d.patch_last(1, {"terminated": 0.0, "is_first": 1.0})
            if done:
                d.stage_reset(reset, done)
            d.grant(grant)
        n_before = len(jrec.blobs)
        jm = jd.pump("carry")[1]
        pm = pd.pump("carry")[1]
        assert (jm is None) == (pm is None)
        trained += pm is not None
        assert len(prec.blobs) == len(jrec.blobs) > n_before
        for jb, pb in zip(jrec.blobs[n_before:], prec.blobs[n_before:]):
            jl = {layout.nbytes: layout for layout in jax_make_blob_layouts(JAX_KEYS, E, 2, (1, 2)).values()}[jb.size]
            pl = {layout.nbytes: layout for layout in make_blob_layouts(KEYS, E, 2, (1, 2)).values()}[pb.size]
            ju, pu = jax_unpack(jnp.asarray(jb), jl), unpack_burst_blob(torch.from_numpy(pb), pl)
            for name in list(KEYS) + ["__mask__", "__pos__", "__valid_n__", "__validmask__"]:
                np.testing.assert_array_equal(pu[name].numpy(), np.asarray(ju[name]), err_msg=name)
        np.testing.assert_array_equal(pd.dev_pos, jd.dev_pos)
        np.testing.assert_array_equal(pd.dev_valid, jd.dev_valid)
        assert (pd.grant_backlog, pd.gradient_steps, pd.train_steps) == (jd.grant_backlog, jd.gradient_steps, jd.train_steps)
        assert pd.metrics()["Replay/flushes"] == jd.metrics()["Replay/flushes"]
    assert trained > 5 and pd.dev_valid.min() == CAP  # the ring wrapped
    # both buckets flushed: 1 row, and 2 rows with a reset
    assert {b.size for b in prec.blobs} == {layout.nbytes for layout in make_blob_layouts(KEYS, E, 2, (1, 2)).values()}


def _probe_jax(carry, xs):
    batch, _key = xs
    w = jnp.arange(1, T * B + 1, dtype=jnp.float32).reshape(T, B)
    return carry + 1, (jnp.sum(batch["rewards"][..., 0] * w), jnp.sum(batch["rgb"].astype(jnp.float32)),
                       jnp.sum(batch["is_first"][..., 0] * w))


def _probe_port(carry, xs):
    batch, _noise = xs
    w = torch.arange(1, T * B + 1, dtype=torch.float32).reshape(T, B)
    return carry + 1, torch.stack([(batch["rewards"][..., 0] * w).sum(), batch["rgb"].sum(),
                                   (batch["is_first"][..., 0] * w).sum()])


def _filled_ring(rng):
    """A ring whose ``rewards`` name their slot (row * E + env), random
    elsewhere, and per-env heads: env 0 full, env 1 filling, env 2 full."""
    ring = {k: rng.integers(0, 100, (CAP, E) + s).astype(d) for k, (s, d) in KEYS.items()}
    ring["rewards"] = (np.arange(CAP)[:, None] * E + np.arange(E)[None, :]).astype(np.float32)[..., None]
    return ring, np.array([5, 7, 2], np.int32), np.array([CAP, 7, CAP], np.int32)


@pytest.mark.parametrize("granted", [1, 2])
def test_torch_seq_ring_burst_matches_jax_with_a_probe_step(fabric, granted):
    """One 2-row dispatch (a regular row and a ragged reset row) with
    ``granted`` of 3 steps: the ring after the append, the windows and the
    probe's averaged checksums equal JAX's."""
    rng = np.random.default_rng(granted)
    ring, pos, valid = _filled_ring(rng)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": 3, "seq_len": T, "batch_size": B,
            "ring_keys": JAX_KEYS, "stage_buckets": (1, 2), "stage_max": 2}
    staged = {k: rng.integers(100, 200, (2, E) + s).astype(d) for k, (s, d) in KEYS.items()}
    mask = np.array([[1, 1, 1], [0, 1, 0]], np.int32)
    validmask = np.array([1.0] * granted + [0.0] * (3 - granted), np.float32)
    key = jax.random.PRNGKey(granted + 10)
    values = {**staged, "__mask__": mask, "__pos__": pos, "__valid_n__": valid, "__validmask__": validmask}

    jax_fn = jax_build_burst(_probe_jax, fabric.mesh, spec)
    jax_blob = jax_pack(jax_make_blob_layouts(JAX_KEYS, E, 3, (1, 2))[2], {**values, "__key__": np.asarray(key, np.uint32)})
    jcarry, jrb, jmetrics = jax_fn(jnp.int32(0), {k: jnp.asarray(v) for k, v in ring.items()}, jnp.asarray(jax_blob))

    # JAX's draws, rebuilt from its key: fold_in of the device index, one key per step, split in 3
    keys = jax.random.split(jax.random.fold_in(key, 0), 3)[:granted]
    env_idx, u = [], []
    for k in keys:
        k_env, k_start, _ = jax.random.split(k, 3)
        env_idx.append(np.array(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.asarray(jax.random.uniform(k_start, (B,))))
    _, new_pos, new_valid = jax_ring_append_rows(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(mask), CAP)
    for k, ei in zip(keys, env_idx):
        k_start = jax.random.split(k, 3)[1]
        want_t = np.asarray(jax_ring_sample_windows(k_start, jnp.asarray(ei), new_pos, new_valid, CAP, T))
        got_t = ring_sample_windows(torch.from_numpy(np.array(jax.random.uniform(k_start, (B,)))),
                                    torch.from_numpy(ei).long(), torch.from_numpy(np.array(new_pos)),
                                    torch.from_numpy(np.array(new_valid)), CAP, T)
        np.testing.assert_array_equal(got_t.numpy(), want_t)

    port_fn = build_burst_train_step(_probe_port, {**spec, "ring_keys": KEYS}, draw_noise=lambda gen: None)
    rb = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    blob = pack_burst_blob(make_blob_layouts(KEYS, E, 3, (1, 2))[2], values)
    draws = {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)),
             "noise": [None] * granted}
    pcarry, prb, pmetrics = port_fn(0, rb, blob, None, draws)
    assert prb is rb and pcarry == int(jcarry) == granted
    for k in KEYS:
        np.testing.assert_array_equal(rb[k].numpy(), np.asarray(jrb[k]), err_msg=k)
    np.testing.assert_array_equal(pmetrics.numpy(), np.asarray(jnp.stack(jmetrics)))


def test_torch_seq_ring_burst_holds_grants_until_every_env_has_a_window():
    """The gate of the JAX program: granted steps with an env shorter than a
    window run nothing (and draw nothing)."""
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": 1, "seq_len": T, "batch_size": B,
            "ring_keys": KEYS, "stage_buckets": (1, 2)}
    calls = []
    fn = build_burst_train_step(lambda c, xs: calls.append(1) or (c, torch.zeros(1)), spec, lambda gen: None)
    rb = {k: torch.zeros((CAP, E) + s, dtype=torch.from_numpy(np.zeros(0, d)).dtype) for k, (s, d) in KEYS.items()}
    values = {k: np.ones((1, E) + s, d) for k, (s, d) in KEYS.items()}
    values.update(__mask__=np.ones((1, E), np.int32), __pos__=np.array([3, 3, 2], np.int32),
                  __valid_n__=np.array([3, 3, 2], np.int32), __validmask__=np.ones(1, np.float32))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    carry, _, metrics = fn(0, rb, pack_burst_blob(make_blob_layouts(KEYS, E, 1, (1, 2))[1], values), gen)
    assert metrics is None and not calls and torch.equal(gen.get_state(), state)
    assert float(rb["rewards"][3, 0]) == 1.0 and float(rb["rewards"][2, 2]) == 1.0  # the append happened


def _jax_host_buffers(rng, fill):
    rb = JaxEnvIndependent(CAP, n_envs=E, obs_keys=("rgb",), buffer_cls=JaxSequential)
    port = EnvIndependentReplayBuffer(CAP, E, ("rgb",))
    for t in range(fill):
        data = {**_step_data(rng), "truncated": np.zeros((1, E, 1), np.float32)}
        rb.add(data)
        port.add(data)
        if t % 7 == 3:
            reset = {k: v[:, [1]] for k, v in _step_data(rng).items()}
            reset["truncated"] = np.zeros((1, 1, 1), np.float32)
            rb.add(reset, [1])
            port.add(reset, [1])
    return rb, port


def test_torch_seq_ring_mirrors_host_buffers_like_jax(fabric):
    """``init_device_ring`` filled from per-env host buffers (a resume into
    the ring): storage and heads equal JAX's, the envs at ragged heads."""
    jrb, prb = _jax_host_buffers(np.random.default_rng(4), 20)
    jdev, jpos, jvalid = jax_init_device_ring(fabric, JAX_KEYS, CAP, E, rb=jrb)
    pdev, ppos, pvalid = init_device_ring(KEYS, CAP, E, "cpu", rb=prb)
    for k in KEYS:
        np.testing.assert_array_equal(pdev[k].numpy(), np.asarray(jdev[k]), err_msg=k)
    np.testing.assert_array_equal(ppos, jpos)
    np.testing.assert_array_equal(pvalid, jvalid)
    assert len(set(ppos.tolist())) > 1 and pvalid.max() == CAP
    empty, pos, valid = init_device_ring(KEYS, CAP, E, "cpu")
    assert all(not v.any() for v in empty.values()) and not pos.any() and not valid.any()


def _snapshot(rng):
    ring, pos, valid = _filled_ring(rng)
    arrays = {f"storage/{k}": v for k, v in ring.items()}
    arrays.update(pos=pos.astype(np.int64), valid=valid.astype(np.int64), key=np.array([0, 5], np.uint32))
    return arrays, {"capacity": CAP, "n_envs": E, "seq_len": T}


def test_torch_seq_ring_restores_host_buffers_like_jax():
    """A sequence snapshot restored into host per-env buffers (the resume
    onto the host tier, ``truncated`` filled in): each env's storage and
    head equal JAX's, and the two then sample the same windows."""
    arrays, meta = _snapshot(np.random.default_rng(5))
    jrb = JaxEnvIndependent(CAP, n_envs=E, obs_keys=("rgb",), buffer_cls=JaxSequential)
    jax_restore_host_env_buffer(JaxDeviceReplayState("sequence", arrays, meta), jrb,
                                fill_missing={"truncated": ((1,), np.float32)})
    prb = EnvIndependentReplayBuffer(CAP, E, ("rgb",))
    restore_host_env_buffer(sequence_ring_from_jax(arrays, meta), prb, fill_missing={"truncated": ((1,), np.float32)})
    for jsub, psub in zip(jrb.buffer, prb.buffer):
        assert (psub.pos, psub.full) == (jsub._pos, jsub.full)
        assert set(psub.buffer) == set(KEYS) | {"truncated"}
        for k in psub.buffer:
            np.testing.assert_array_equal(psub.buffer[k], np.asarray(jsub.buffer[k]), err_msg=k)
    jrb.seed(9)
    prb.seed(9)
    want = jrb.sample(4, sequence_length=T, n_samples=2)
    got = prb.sample(4, sequence_length=T, n_samples=2)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="does not match"):
        restore_host_env_buffer(sequence_ring_from_jax(arrays, meta), EnvIndependentReplayBuffer(CAP * 2, E))
    with pytest.raises(ValueError, match="uniform"):
        restore_host_env_buffer(DeviceReplayState("uniform", {}, meta), prb)


def test_torch_seq_ring_checkpoint_round_trip_and_jax_snapshot(tmp_path):
    """``state_dict`` through a checkpoint file restores the ring, heads and
    generator exactly; staged rows refuse a checkpoint; a converted JAX
    snapshot restores ring and heads and leaves the generator as seeded."""
    rng = np.random.default_rng(6)
    d = SequenceRingDriver(KEYS, CAP, E, T, B, 1, _Recorder(), seed=7)
    arrays, meta = _snapshot(rng)
    d.load_state_dict(sequence_ring_from_jax(arrays, meta))
    assert torch.equal(d.generator.get_state(), torch.Generator().manual_seed(7).get_state())
    for k in KEYS:
        np.testing.assert_array_equal(d.rb_dev[k].numpy(), arrays[f"storage/{k}"])
    np.testing.assert_array_equal(d.dev_pos, arrays["pos"])
    torch.rand(5, generator=d.generator)  # move the generator off its seed
    d.stage_step(_step_data(rng))
    with pytest.raises(RuntimeError, match="staged"):
        d.state_dict()
    d.pump(None)
    path = save_checkpoint(tmp_path / "ckpt.ckpt", {"rb": d.state_dict().to_dict()})
    snap = DeviceReplayState.from_dict(load_checkpoint(path)["rb"])
    fresh = SequenceRingDriver(KEYS, CAP, E, T, B, 1, _Recorder(), seed=0, restore=snap)
    for k in KEYS:
        assert torch.equal(fresh.rb_dev[k], d.rb_dev[k])
    np.testing.assert_array_equal(fresh.dev_pos, d.dev_pos)
    np.testing.assert_array_equal(fresh.dev_valid, d.dev_valid)
    assert torch.equal(fresh.generator.get_state(), d.generator.get_state())
    with pytest.raises(ValueError, match="mismatch"):
        SequenceRingDriver(KEYS, CAP * 2, E, T, B, 1, _Recorder(), restore=snap)
