"""The port's device-resident replay (``sheeprl_tpu_torch/replay/device_buffer.py``,
``data/ring.py``'s layout helpers) against the JAX package's
``sheeprl_tpu.replay.DeviceReplayBuffer`` on a one-device CPU mesh.

Rows are numpy from a seed. The JAX ring appends through its own append
program (``make_append_step``: the same scatter at the write head, fresh
PER leaves at ``max_p``, as its fused SAC step does); the port through
``make_job`` (one packed upload) and ``append``. What must agree, exactly
(the same float32 values are written and the same pairs summed): the
storage through a wrap-around, the write head, the sum-tree and ``max_p``
after fresh leaves enter at a raised ``max_p``; the byte layout of the
packed upload; the checkpoint round trip (storage, tree, ``max_p``, head
and the train-draw generator); both crossovers between the device ring and
the host buffer; and the HBM sizing rule.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.data.ring import make_layout as jax_make_layout
from sheeprl_tpu.data.ring import pack_burst_blob as jax_pack
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu.replay import DeviceReplayBuffer as JaxDeviceReplayBuffer
from sheeprl_tpu.replay import estimate_ring_bytes as jax_estimate
from sheeprl_tpu.replay import resolve_device_resident as jax_resolve
from sheeprl_tpu.replay import restore_host_buffer as jax_restore_host_buffer
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.data.ring import make_layout, pack_burst_blob, unpack_burst_blob
from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState, estimate_ring_bytes, resolve_device_resident
from sheeprl_tpu_torch.replay import restore_host_buffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

CAP, N_ENVS = 8, 2
SPECS = {
    "observations": ((3,), np.float32),
    "next_observations": ((3,), np.float32),
    "actions": ((1,), np.float32),
    "rewards": ((1,), np.float32),
    "terminated": ((1,), np.float32),
}


@pytest.fixture(scope="module")
def fabric():
    return Fabric(devices=1, accelerator="cpu")


def _row(rng):
    return {k: rng.normal(size=(1, N_ENVS) + shape).astype(np.float32) for k, (shape, _) in SPECS.items()}


def _pair(fabric, prioritized, rows, seed=0, max_p=None):
    """A JAX ring and the port's, each fed the same ``rows`` rows."""
    jdrb = JaxDeviceReplayBuffer(fabric, {k: (s, jnp.float32) for k, (s, _) in SPECS.items()}, CAP, N_ENVS,
                                 prioritized=prioritized, seed=29)
    pdrb = DeviceReplayBuffer(SPECS, CAP, N_ENVS, prioritized=prioritized, seed=29)
    if max_p is not None:
        jdrb.state["max_p"] = jnp.float32(max_p)
        pdrb.max_p.fill_(max_p)
    append = jdrb.make_append_step(donate=False)
    rng = np.random.default_rng(seed)
    for _ in range(rows):
        row = _row(rng)
        jdrb.state = append(jdrb.state, jnp.asarray(jdrb.pack_rows([{k: v[0] for k, v in row.items()}])))
        jdrb.note_append(1)
        pdrb.add(row)
        pdrb.append(pdrb.make_job())
    return jdrb, pdrb


def _same_ring(jdrb, pdrb, rows=CAP):
    """Equal storage in the first ``rows`` rows, heads, tree and ``max_p``."""
    for k in SPECS:
        np.testing.assert_array_equal(pdrb.storage[k][:rows].numpy(), np.asarray(jdrb.state["storage"][k])[:rows], err_msg=k)
    assert (pdrb.pos, pdrb.full, pdrb.valid_rows) == (jdrb.pos, jdrb.full, jdrb.valid_rows)
    assert pdrb.pos == int(jdrb.state["pos"]) and pdrb.valid_rows == int(jdrb.state["valid"])
    if pdrb.prioritized:
        np.testing.assert_array_equal(pdrb.tree.numpy(), np.asarray(jdrb.state["tree"]))
        assert float(pdrb.max_p) == float(jdrb.state["max_p"])


def test_torch_sac_replay_layout_helpers_match_jax():
    spec = [("observations", (1, 4, 3), np.float32), ("__count__", (), np.int32), ("u8", (3,), np.uint8),
            ("rewards", (1, 4, 1), np.float32)]
    layout = make_layout(spec)
    assert layout == jax_make_layout(spec) and layout.nbytes % 4 == 0
    rng = np.random.default_rng(1)
    values = {"observations": rng.normal(size=(1, 4, 3)).astype(np.float32), "__count__": np.int32(1),
              "u8": np.array([7, 8, 9], np.uint8), "rewards": rng.normal(size=(1, 4, 1)).astype(np.float32)}
    blob = pack_burst_blob(layout, values)
    assert blob.dtype == torch.uint8 and np.array_equal(blob.numpy(), jax_pack(jax_make_layout(spec), values))
    out = unpack_burst_blob(blob, layout)
    for k, v in values.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        assert out[k].data_ptr() >= blob.data_ptr()  # views of the one upload


@pytest.mark.parametrize("rows", [5, 8, 11], ids=["partial", "one-lap", "wraps"])
def test_torch_sac_replay_appends_like_jax(fabric, rows):
    _same_ring(*_pair(fabric, False, rows, seed=rows))


@pytest.mark.parametrize("rows", [3, 11], ids=["partial", "wraps"])
def test_torch_sac_replay_per_fresh_leaves_enter_at_max_p_like_jax(fabric, rows):
    jdrb, pdrb = _pair(fabric, True, rows, seed=rows, max_p=2.5)
    _same_ring(jdrb, pdrb)
    P = pdrb.tree_leaves
    filled = pdrb.valid_rows * N_ENVS
    assert P == 16 and float(pdrb.tree[1]) == 2.5 * filled
    assert torch.equal(pdrb.tree[P : P + filled], torch.full((filled,), 2.5))


def test_torch_sac_replay_job_is_one_upload_and_a_drain_job_appends_nothing(fabric):
    pdrb = DeviceReplayBuffer(SPECS, CAP, N_ENVS, prioritized=True)
    pdrb.add(_row(np.random.default_rng(2)))
    with pytest.raises(RuntimeError, match="one row"):
        pdrb.add(_row(np.random.default_rng(3)))
    with pytest.raises(RuntimeError, match="staged"):
        pdrb.state_dict()
    job = pdrb.make_job()
    assert job.blob.dtype == torch.uint8 and job.blob.numel() == pdrb.layout.nbytes == 4 * N_ENVS * 9
    assert (job.pos, job.count, job.valid) == (0, 1, 1)
    pdrb.append(job)
    drain = pdrb.make_job()
    assert (drain.blob, drain.count, drain.pos, drain.valid) == (None, 0, 1, 1)
    tree = pdrb.tree.clone()
    pdrb.append(drain)
    assert torch.equal(tree, pdrb.tree) and pdrb.pos == 1
    m = pdrb.metrics()
    assert m["Replay/flushes"] == 2 and m["Replay/inserts"] == N_ENVS and m["Replay/size"] == N_ENVS


@pytest.mark.parametrize("prioritized", [True, False], ids=["per", "uniform"])
def test_torch_sac_replay_checkpoint_round_trip(fabric, tmp_path, prioritized):
    _, pdrb = _pair(fabric, prioritized, 11, seed=4, max_p=1.75 if prioritized else None)
    torch.rand(5, generator=pdrb.generator)  # the draw stream moved on
    path = save_checkpoint(tmp_path / "ckpt.ckpt", {"rb": pdrb.state_dict().to_dict()})
    back = DeviceReplayBuffer(SPECS, CAP, N_ENVS, prioritized=prioritized, seed=0)
    back.load_state_dict(DeviceReplayState.from_dict(load_checkpoint(path)["rb"]))
    for k in SPECS:
        assert torch.equal(back.storage[k], pdrb.storage[k])
    assert (back.pos, back.full) == (pdrb.pos, pdrb.full)
    if prioritized:
        assert torch.equal(back.tree, pdrb.tree) and float(back.max_p) == 1.75
    assert torch.equal(torch.rand(4, generator=back.generator), torch.rand(4, generator=pdrb.generator))
    with pytest.raises(ValueError, match="mismatch"):
        DeviceReplayBuffer(SPECS, CAP * 2, N_ENVS).load_state_dict(pdrb.state_dict())


def test_torch_sac_replay_restores_the_host_buffer_like_jax(fabric):
    """Device ring -> host buffer (a resident checkpoint resumed on the host
    tier), ``truncated`` zero-filled."""
    jdrb, pdrb = _pair(fabric, True, 11, seed=5)
    jrb, prb = JaxReplayBuffer(CAP, N_ENVS, memmap=False), ReplayBuffer(CAP, N_ENVS)
    missing = {"truncated": ((1,), np.uint8)}
    jax_restore_host_buffer(jdrb.state_dict(), jrb, fill_missing=missing)
    restore_host_buffer(pdrb.state_dict(), prb, fill_missing=missing)
    assert sorted(prb.buffer) == sorted(jrb.buffer)
    for k in jrb.buffer:
        np.testing.assert_array_equal(prb.buffer[k], np.asarray(jrb.buffer[k]), err_msg=k)
        assert prb.buffer[k].dtype == np.asarray(jrb.buffer[k]).dtype
    assert (prb.pos, prb.full) == (jrb._pos, jrb.full)


@pytest.mark.parametrize("rows", [5, 11])
def test_torch_sac_replay_loads_a_host_buffer_like_jax(fabric, rows):
    """Host buffer -> device ring (a host checkpoint resumed on the device
    tier): storage copied, filled leaves at priority 1."""
    rng = np.random.default_rng(rows)
    jrb, prb = JaxReplayBuffer(CAP, N_ENVS, memmap=False), ReplayBuffer(CAP, N_ENVS)
    for _ in range(rows):
        row = _row(rng)
        row["truncated"] = np.zeros((1, N_ENVS, 1), np.uint8)
        jrb.add(row)
        prb.add(row)
    jdrb = JaxDeviceReplayBuffer(fabric, {k: (s, jnp.float32) for k, (s, _) in SPECS.items()}, CAP, N_ENVS,
                                 prioritized=True)
    jdrb.load_host_buffer(jrb)
    pdrb = DeviceReplayBuffer(SPECS, CAP, N_ENVS, prioritized=True).load_host_buffer(prb)
    _same_ring(jdrb, pdrb, rows=min(rows, CAP))  # host rows past the head were never written


def test_torch_sac_replay_sizes_the_ring_like_jax():
    specs = {k: ((3,) if "obs" in k else (1,), np.float32) for k in SPECS}
    for capacity, n_envs, prioritized in ((250_000, 4, True), (250_000, 4, False), (64, 2, True)):
        got = estimate_ring_bytes(specs, capacity, n_envs, prioritized)
        assert got == jax_estimate(specs, capacity, n_envs, 1, False, prioritized)
    assert estimate_ring_bytes(specs, 250_000, 4, True) == 36_000_000 + 8 * 2**20  # the sac_per configuration
    for prioritized in (False, True):
        for setting, budget in ((True, 4.0), ("auto", 0.01), ("auto", 4.0), (False, 4.0), ("true", 0.01)):
            if prioritized and setting is not False and budget < 1:
                # the host tier has no PER: the port refuses where JAX would spill to uniform sampling
                with pytest.raises(ValueError, match="no PER"):
                    resolve_device_resident(setting, specs, 250_000, 4, budget, prioritized)
                continue
            with pytest.warns(UserWarning) if setting in (True, "true") and budget < 1 else contextlib.nullcontext():
                got = resolve_device_resident(setting, specs, 250_000, 4, budget, prioritized)
            want = jax_resolve(setting, specs, 250_000, 4, 1, budget, prioritized)
            assert got[0] == want[0]
    with pytest.raises(ValueError, match="true/false/auto"):
        resolve_device_resident("maybe", specs, 8, 2, 4.0)
