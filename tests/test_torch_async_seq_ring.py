"""The port's async (Sebulba) sequence ring against the JAX package's, on the
CPU: ``replay/driver.py``'s ``AsyncSequenceRing`` and ``SeqBlobWriter``,
``data/ring.py``'s ``make_seq_append_layout``, ``build_seq_append_step`` and
``build_seq_train_step``, ``utils/convert.py``'s ``sequence_ring_from_jax``,
and ``parallel/pipeline.py``'s ``ParamServer.pull(prefer_ready=True)``.

- The writer's blob: every masked cell, the masks and the offset equal the
  bytes of JAX's ``SeqBlobWriter`` fed the same rows; ``pack_rows`` equals
  JAX's ``pack_rows`` byte for byte, is pure and refuses too many rows.
- Appends from two interleaved actors at env columns 0 and ``e`` (a ring of
  9 rows, so it wraps, with ragged reset rows) leave the storage and the
  per-env heads bit-equal to JAX's ``build_seq_append_step`` after every
  blob; the host mirrors equal the device heads.
- Grants hold until every env column holds a window: ``ready()``, and a
  train dispatch with a short column runs nothing and draws nothing.
- One append-free dispatch with a probe step (integer checksums of its
  window, exact in float32), fed the env indices and uniforms JAX draws
  from its key (``split``, ``fold_in`` of the device index, ``split(G)``,
  ``split(k, 3)``), averages JAX's checksums exactly: the same windows.
- A checkpoint round trip restores the storage, heads and generator
  exactly; a JAX async snapshot converts (its key stays behind).
- ``prefer_ready``: the newest snapshot whose copy event has completed, the
  newest when none has (stub events), newest-wins without events.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.ring import build_seq_train_step as jax_build_seq_train_step
from sheeprl_tpu.data.ring import make_seq_ctl_layout as jax_make_seq_ctl_layout
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.data.ring import unpack_burst_blob as jax_unpack
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu.replay import AsyncSequenceRing as JaxAsyncSequenceRing
from sheeprl_tpu.replay import SeqBlobWriter as JaxSeqBlobWriter
from sheeprl_tpu_torch.data.ring import (
    build_seq_train_step,
    make_seq_append_layout,
    make_seq_ctl_layout,
    pack_burst_blob,
    unpack_burst_blob,
)
from sheeprl_tpu_torch.parallel.pipeline import ParamServer
from sheeprl_tpu_torch.replay import AsyncSequenceRing, DeviceReplayState, SeqBlobWriter
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.convert import sequence_ring_from_jax

CAP, LOCAL, ACTORS, T, B, STAGE = 9, 2, 2, 3, 4, 4
E = LOCAL * ACTORS
KEYS = {
    "rgb": ((2, 2, 3), np.uint8),
    "state": ((3,), np.float32),
    "actions": ((2,), np.float32),
    "rewards": ((1,), np.float32),
    "terminated": ((1,), np.float32),
    "is_first": ((1,), np.float32),
}
JAX_KEYS = {k: (s, jnp.dtype(d)) for k, (s, d) in KEYS.items()}


@pytest.fixture(scope="module")
def fabric():
    return Fabric(devices=1, accelerator="cpu")


def _row(rng):
    return {k: rng.integers(1, 250, (LOCAL,) + s).astype(d) for k, (s, d) in KEYS.items()}


def _block(rng, regular: int):
    """``regular`` all-env rows, each followed by a ragged reset row where
    an env is done."""
    rows = []
    for _ in range(regular):
        rows.append((_row(rng), np.ones(LOCAL, np.int32)))
        done = (rng.random(LOCAL) < 0.35).astype(np.int32)
        if done.any() and len(rows) < STAGE:
            rows.append((_row(rng), done))
    return rows[:STAGE]


def _masked_equal(got: dict, want: dict, mask: np.ndarray) -> None:
    for k in KEYS:
        m = mask.astype(bool)
        np.testing.assert_array_equal(got[k][m], want[k][m], err_msg=k)
    np.testing.assert_array_equal(got["__mask__"], want["__mask__"])
    assert int(got["__offset__"]) == int(want["__offset__"])


def test_torch_async_seq_ring_writer_and_pack_rows_match_jax(fabric):
    """Three blobs through both writers (stale bytes in unwritten slots are
    allowed: only masked cells reach the ring), and ``pack_rows``."""
    rng = np.random.default_rng(0)
    jring = JaxAsyncSequenceRing(fabric, JAX_KEYS, CAP, E, LOCAL, T, STAGE, seed=1)
    pring = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE, seed=1)
    assert make_seq_append_layout(KEYS, LOCAL, STAGE) == pring.append_layout
    assert pring.append_layout.segments == jring.append_layout.segments
    jw, pw = JaxSeqBlobWriter(jring, LOCAL), SeqBlobWriter(pring, LOCAL)
    for regular in (2, 3, 1):
        rows = _block(rng, regular)
        for data, mask in rows:
            jv, pv = jw.row(mask), pw.row(mask)
            for k in KEYS:
                jv[k][...] = data[k]
                pv[k][...] = data[k]
        jblob, jcounts = jw.ship()
        pblob, pcounts = pw.ship()
        np.testing.assert_array_equal(pcounts, jcounts)
        assert pblob.dtype == torch.uint8 and pblob.numel() == jblob.size
        got = {k: v.numpy() for k, v in unpack_burst_blob(pblob, pring.append_layout).items()}
        want = {k: np.asarray(v) for k, v in jax_unpack(jnp.asarray(jblob.copy()), jring.append_layout).items()}
        _masked_equal(got, want, want["__mask__"])
        # pack_rows: the same rows, byte for byte, and nothing of the ring moved
        before = {k: v.clone() for k, v in pring.state["storage"].items()}
        packed = pring.pack_rows(rows, LOCAL)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jring.pack_rows(rows, LOCAL)))
        assert torch.equal(packed, pring.pack_rows(rows, LOCAL))
        assert all(torch.equal(v, before[k]) for k, v in pring.state["storage"].items())
        assert not pring.host_valid.any() and not pring.state["valid"].any()
    with pytest.raises(ValueError, match="stage_rows"):
        pring.pack_rows([(_row(rng), np.ones(LOCAL, np.int32))] * (STAGE + 1), 0)
    with pytest.raises(RuntimeError, match="ship before staging more"):
        for _ in range(STAGE + 1):
            pw.row(np.ones(LOCAL, np.int32))


def test_torch_async_seq_ring_checks_its_shape():
    with pytest.raises(ValueError, match="multiple of the per-actor env batch"):
        AsyncSequenceRing(KEYS, CAP, 5, LOCAL, T, STAGE)
    with pytest.raises(ValueError, match="cannot exceed the ring capacity"):
        AsyncSequenceRing(KEYS, 3, E, LOCAL, T, STAGE)
    ring = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE)
    with pytest.raises(ValueError, match="leaves the ring"):
        ring.append(ring.pack_rows([], 0), E - 1)
    with pytest.raises(ValueError, match="at least 2 slabs"):
        SeqBlobWriter(ring, 0, slots=1)


def test_torch_async_seq_ring_interleaved_appends_match_jax_bit_for_bit(fabric):
    """Two actors' blobs, interleaved, at env columns 0 and LOCAL: 10 blobs
    into 9 rows per column, so every column wraps; after every commit the
    storage and both heads equal JAX's, and the host mirrors the device."""
    rng = np.random.default_rng(1)
    jring = JaxAsyncSequenceRing(fabric, JAX_KEYS, CAP, E, LOCAL, T, STAGE, seed=2)
    pring = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE, seed=2)
    resets = 0
    for i in range(10):
        aid = i % ACTORS if i < 6 else (i // 2) % ACTORS  # interleaved, then one actor twice in a row
        rows = _block(rng, int(rng.integers(1, 4)))
        resets += sum(int(m.sum() < LOCAL) for _, m in rows)
        counts = np.zeros(E, np.int64)
        counts[aid * LOCAL:(aid + 1) * LOCAL] = sum(m for _, m in rows)
        jblob = jring.pack_rows(rows, aid * LOCAL)
        jring.append(jnp.asarray(jblob))
        jring.note_append(counts, jblob.nbytes)
        pring.append(pring.pack_rows(rows, aid * LOCAL), aid * LOCAL)
        pring.note_append(counts, 0)
        for k in KEYS:
            np.testing.assert_array_equal(pring.state["storage"][k].numpy(), np.asarray(jring.state["storage"][k]),
                                          err_msg=f"blob {i}, {k}")
        for h in ("pos", "valid"):
            np.testing.assert_array_equal(pring.state[h].numpy(), np.asarray(jring.state[h]), err_msg=f"blob {i} {h}")
        np.testing.assert_array_equal(pring.host_pos, pring.state["pos"].numpy())
        np.testing.assert_array_equal(pring.host_valid, pring.state["valid"].numpy())
        np.testing.assert_array_equal(pring.host_valid, jring.host_valid)
    assert resets > 0 and (pring.host_valid == CAP).all()  # ragged reset rows, and every column wrapped
    assert len(set(pring.host_pos.tolist())) > 1  # the heads are ragged
    assert pring.metrics()["Replay/flushes"] == 10


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


def _filled_state(rng):
    """Storage whose ``rewards`` name their slot (row * E + env), and
    ragged heads: two columns full, two filling."""
    storage = {k: rng.integers(0, 100, (CAP, E) + s).astype(d) for k, (s, d) in KEYS.items()}
    storage["rewards"] = (np.arange(CAP)[:, None] * E + np.arange(E)[None, :]).astype(np.float32)[..., None]
    return storage, np.array([5, 7, 3, 0], np.int32), np.array([CAP, 7, 3, CAP], np.int32)


@pytest.mark.parametrize("granted", [1, 3])
def test_torch_async_seq_ring_dispatch_draws_jax_windows_with_a_probe_step(fabric, granted):
    rng = np.random.default_rng(granted)
    storage, pos, valid = _filled_state(rng)
    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": 3, "seq_len": T, "batch_size": B}
    validmask = np.array([1.0] * granted + [0.0] * (3 - granted), np.float32)
    key = jax.random.PRNGKey(granted + 20)
    jfn, jlayout = jax_build_seq_train_step(_probe_jax, fabric.mesh, spec)
    state = {"storage": {k: jnp.asarray(v) for k, v in storage.items()}, "pos": jnp.asarray(pos),
             "valid": jnp.asarray(valid), "key": key}
    jcarry, new_key, jmetrics = jfn(jnp.int32(0), state, jnp.asarray(jax_pack(jlayout, {"__validmask__": validmask})))
    # JAX's draws, rebuilt from its key
    _, k_dispatch = jax.random.split(key)
    keys = jax.random.split(jax.random.fold_in(k_dispatch, 0), 3)[:granted]
    env_idx, u = [], []
    for k in keys:
        k_env, k_start, _ = jax.random.split(k, 3)
        env_idx.append(np.array(jax.random.randint(k_env, (B,), 0, E)))
        u.append(np.asarray(jax.random.uniform(k_start, (B,))))

    pfn, playout = build_seq_train_step(_probe_port, spec, draw_noise=lambda gen: None)
    assert playout == make_seq_ctl_layout(3) and playout.segments == jax_make_seq_ctl_layout(3).segments
    pstate = {"storage": {k: torch.from_numpy(v.copy()) for k, v in storage.items()}, "pos": torch.from_numpy(pos),
              "valid": torch.from_numpy(valid)}
    draws = {"env": torch.from_numpy(np.stack(env_idx)).long(), "u": torch.from_numpy(np.stack(u)),
             "noise": [None] * granted}
    pcarry, pmetrics = pfn(0, pstate, pack_burst_blob(playout, {"__validmask__": validmask}), valid, None, draws)
    assert pcarry == int(jcarry) == granted
    np.testing.assert_array_equal(pmetrics.numpy(), np.asarray(jnp.stack(jmetrics)))
    for k in KEYS:  # the dispatch neither copies nor writes the ring
        np.testing.assert_array_equal(pstate["storage"][k].numpy(), storage[k])


def test_torch_async_seq_ring_holds_grants_until_every_column_has_a_window():
    ring = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE)
    calls = []
    fn, layout = build_seq_train_step(lambda c, xs: calls.append(1) or (c, torch.zeros(1)),
                                      {"capacity": CAP, "n_envs": E, "grad_chunk": 2, "seq_len": T, "batch_size": B},
                                      lambda gen: calls.append("noise"))
    rows = [(_row(np.random.default_rng(3)), np.ones(LOCAL, np.int32))] * T
    ring.append(ring.pack_rows(rows, 0), 0)
    ring.note_append(np.array([T, T, 0, 0]), 0)
    assert not ring.ready()
    gen_state = ring.generator.get_state()
    ctl = pack_burst_blob(layout, {"__validmask__": np.ones(2, np.float32)})
    carry, metrics = fn(0, ring.state, ctl, ring.host_valid, ring.generator)
    assert metrics is None and carry == 0 and not calls and torch.equal(ring.generator.get_state(), gen_state)
    ring.append(ring.pack_rows(rows, LOCAL), LOCAL)
    ring.note_append(np.array([0, 0, T, T]), 0)
    assert ring.ready()
    carry, metrics = fn(0, ring.state, ctl, ring.host_valid, ring.generator)
    assert carry == 0 and calls == ["noise", "noise", 1, 1]
    assert not torch.equal(ring.generator.get_state(), gen_state)


def test_torch_async_seq_ring_checkpoint_round_trip_and_jax_snapshot(fabric, tmp_path):
    rng = np.random.default_rng(4)
    ring = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE, seed=5)
    for aid in (0, 1, 0):
        rows = _block(rng, 3)
        ring.append(ring.pack_rows(rows, aid * LOCAL), aid * LOCAL)
        counts = np.zeros(E, np.int64)
        counts[aid * LOCAL:(aid + 1) * LOCAL] = sum(m for _, m in rows)
        ring.note_append(counts, 0)
    torch.rand(7, generator=ring.generator)  # move the generator off its seed
    path = save_checkpoint(tmp_path / "ckpt.ckpt", {"rb": ring.state_dict().to_dict()})
    snap = DeviceReplayState.from_dict(load_checkpoint(path)["rb"])
    fresh = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE, seed=0).load_state_dict(snap)
    for k in KEYS:
        assert torch.equal(fresh.state["storage"][k], ring.state["storage"][k])
    for h in ("pos", "valid"):
        assert torch.equal(fresh.state[h], ring.state[h])
    np.testing.assert_array_equal(fresh.host_pos, ring.host_pos)
    np.testing.assert_array_equal(fresh.host_valid, ring.host_valid)
    assert torch.equal(fresh.generator.get_state(), ring.generator.get_state())
    live = ring.state_dict(live=True)
    assert live.arrays["storage/rgb"] is ring.state["storage"]["rgb"]
    with pytest.raises(ValueError, match="mismatch"):
        AsyncSequenceRing(KEYS, CAP + 1, E, LOCAL, T, STAGE).load_state_dict(snap)
    with pytest.raises(ValueError, match="uniform"):
        fresh.load_state_dict(DeviceReplayState("uniform", {}, snap.meta))

    # a JAX async ring's snapshot: storage and heads carry over, the key does not
    jring = JaxAsyncSequenceRing(fabric, JAX_KEYS, CAP, E, LOCAL, T, STAGE, seed=6)
    for aid in (1, 0, 1):
        rows = _block(rng, 3)
        counts = np.zeros(E, np.int64)
        counts[aid * LOCAL:(aid + 1) * LOCAL] = sum(m for _, m in rows)
        jring.append(jnp.asarray(jring.pack_rows(rows, aid * LOCAL)))
        jring.note_append(counts, 0)
    jsnap = jring.state_dict()
    for converted in (sequence_ring_from_jax(jsnap), sequence_ring_from_jax(jsnap.arrays, jsnap.meta)):
        assert "key" not in converted.arrays
        port = AsyncSequenceRing(KEYS, CAP, E, LOCAL, T, STAGE, seed=9).load_state_dict(converted)
        for k in KEYS:
            np.testing.assert_array_equal(port.state["storage"][k].numpy(), jsnap.arrays[f"storage/{k}"])
        np.testing.assert_array_equal(port.state["pos"].numpy(), jsnap.arrays["pos"])
        np.testing.assert_array_equal(port.host_valid, jsnap.arrays["valid"])
        assert torch.equal(port.generator.get_state(), torch.Generator().manual_seed(9).get_state())
    with pytest.raises(ValueError, match="sequence"):
        sequence_ring_from_jax(DeviceReplayState("uniform", {}, {}))


class _StubEvent:
    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done


def test_torch_async_seq_ring_prefer_ready_takes_the_newest_copied_snapshot():
    module = torch.nn.Linear(2, 2)
    server = ParamServer(module)
    server.publish()
    held, _ = server.pull()  # held: version 1's snapshot is not reused by the next publishes
    server.publish()
    server.publish()
    server.release(held)
    assert server.snapshots == 3
    assert server.pull(prefer_ready=True)[0] == 3  # the CPU has no events: newest-wins
    server.release(3)
    snaps = {s.version: s for s in server._pool}
    snaps[1].event, snaps[2].event, snaps[3].event = _StubEvent(True), _StubEvent(True), _StubEvent(False)
    version, _ = server.pull(prefer_ready=True)
    assert version == 2 and server.stats.ready_fallbacks == 1  # the newest copy in flight, the one before ready
    server.release(version)
    assert server.pull()[0] == 3  # the default pull stays newest-wins
    server.release(3)
    snaps[2].event = _StubEvent(False)
    assert server.pull(prefer_ready=True)[0] == 1
    server.release(1)
    snaps[1].event = _StubEvent(False)
    assert server.pull(prefer_ready=True)[0] == 3  # none ready: the newest
    server.release(3)
    snaps[3].event = _StubEvent(True)
    assert server.pull(prefer_ready=True)[0] == 3
    server.release(3)
