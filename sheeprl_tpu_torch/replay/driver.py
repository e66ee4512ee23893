"""Device-resident sequence replay for DreamerV3 (counterpart of
``SequenceRingDriver``, ``AsyncSequenceRing`` and ``SeqBlobWriter`` in
``sheeprl_tpu/replay/driver.py``).

:class:`SequenceRingDriver` serves the coupled loop synchronously.

The player stays where it is, and every env step dispatches ONE burst: the
append of the staged transitions, then the granted gradient steps with their
windows drawn on the device. No host sampling, no per-step batch upload.

The caller (the algorithm's main) owns the training carry, the grant feed
(``Ratio``) and logging; the driver owns the ring, the staging, the packed
upload, the grant backlog, the ring's generator and the checkpointable ring
state. The heads are host mirrors, advanced from what the host staged,
never read back from the card.

:class:`AsyncSequenceRing` serves the decoupled (Sebulba) topology: actor
threads write their rows into append blobs (:class:`SeqBlobWriter`, or the
pure :meth:`AsyncSequenceRing.pack_rows`), the learner appends each blob at
its actor's env columns and trains at its own cadence through the
append-free dispatch (``data/ring.py:build_seq_train_step``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.ring import BlobLayout, build_seq_append_step, make_blob_layouts, pack_burst_blob
from sheeprl_tpu_torch.parallel.comm import all_true
from sheeprl_tpu_torch.replay.device_buffer import DeviceReplayState
from sheeprl_tpu_torch.utils.burst import init_device_ring

__all__ = ["AsyncSequenceRing", "SeqBlobWriter", "SequenceRingDriver"]

# One env step stages at most one all-envs row plus one ragged reset row.
_STAGE_MAX = 2


class SequenceRingDriver:
    """Owns a per-env-head device sequence ring and dispatches the fused
    append + sample + train burst synchronously, once per env step.

    ``make_burst_fn(ring_spec)`` returns the burst function (DreamerV3's
    ``make_train_step(..., ring=ring_spec)``, which goes through
    :func:`sheeprl_tpu_torch.data.ring.build_burst_train_step`). ``restore``
    is a sequence :class:`DeviceReplayState` (the ring's own checkpoint) or
    per-env host buffers to fill the ring from. The JAX package's key stream
    is the ring's own ``torch.Generator`` on the ring's device, seeded with
    ``seed`` and checkpointed with the ring."""

    def __init__(
        self,
        ring_keys: Dict[str, Tuple[tuple, Any]],
        capacity: int,
        n_envs: int,
        seq_len: int,
        batch_size: int,
        grad_chunk: int,
        make_burst_fn: Callable[[Dict[str, Any]], Callable],
        *,
        device: "torch.device | str" = "cpu",
        seed: int = 0,
        restore: Optional[Any] = None,
    ) -> None:
        self.device = torch.device(device)
        self.ring_keys = {k: (tuple(int(s) for s in shape), np.dtype(dtype)) for k, (shape, dtype) in ring_keys.items()}
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.seq_len = int(seq_len)
        self.grad_chunk = int(grad_chunk)
        buckets = (1, _STAGE_MAX)
        self._burst_fn = make_burst_fn({
            "capacity": self.capacity,
            "n_envs": self.n_envs,
            "grad_chunk": self.grad_chunk,
            "seq_len": self.seq_len,
            "batch_size": int(batch_size),
            "ring_keys": self.ring_keys,
            "stage_buckets": buckets,
            "stage_max": _STAGE_MAX,
        })
        self._layouts = make_blob_layouts(self.ring_keys, self.n_envs, self.grad_chunk, buckets)

        self._staged: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = []
        self._group_ready = False  # every rank's ring has held a window in every env
        self.grant_backlog = 0
        self.gradient_steps = 0
        self.train_steps = 0
        self._metrics = {"flushes": 0, "bytes_staged": 0, "insert_latency_s": 0.0, "dispatch_latency_s": 0.0}

        host_rb = restore if not isinstance(restore, DeviceReplayState) else None
        self.rb_dev, pos, valid = init_device_ring(self.ring_keys, self.capacity, self.n_envs, self.device, rb=host_rb)
        self.dev_pos = np.asarray(pos, np.int64)
        self.dev_valid = np.asarray(valid, np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        if isinstance(restore, DeviceReplayState):
            self.load_state_dict(restore)

    # -- staging ---------------------------------------------------------------
    def stage_step(self, step_data: Dict[str, np.ndarray]) -> None:
        """Stage a regular all-envs row from ``(1, n_envs, ...)`` step data."""
        row = {k: np.asarray(step_data[k][0]) for k in self.ring_keys}
        self._staged.append((row, np.ones(self.n_envs, np.int32)))

    def stage_reset(self, reset_data: Dict[str, np.ndarray], env_idxes) -> None:
        """Stage a ragged reset row: only the done envs advance their heads
        (as ``EnvIndependentReplayBuffer.add(data, env_idxes)`` does)."""
        mask = np.zeros(self.n_envs, np.int32)
        mask[env_idxes] = 1
        row = {}
        for k, (shape, dtype) in self.ring_keys.items():
            full_row = np.zeros((self.n_envs,) + shape, dtype)
            full_row[env_idxes] = np.asarray(reset_data[k][0])
            row[k] = full_row
        self._staged.append((row, mask))

    def patch_last(self, env_idx: int, updates: Dict[str, float]) -> None:
        """In-place edit of the newest staged row for one env (the truncation
        patch on an env restart)."""
        if self._staged:
            for k, v in updates.items():
                self._staged[-1][0][k][env_idx] = v

    # -- grants and dispatch -----------------------------------------------------
    def grant(self, n: int) -> None:
        self.grant_backlog += int(n)

    def _flush(self, carry: Any) -> Tuple[Any, int, Any]:
        t0 = time.perf_counter()
        n_rows = len(self._staged)
        size = next(b for b in sorted(self._layouts) if b >= max(n_rows, 1))
        values: Dict[str, np.ndarray] = {}
        for k, (shape, dtype) in self.ring_keys.items():
            arr = np.zeros((size, self.n_envs) + shape, dtype)
            for i, (row, _m) in enumerate(self._staged):
                arr[i] = row[k]
            values[k] = arr
        mask = np.zeros((size, self.n_envs), np.int32)
        for i, (_r, m) in enumerate(self._staged):
            mask[i] = m
        self._staged.clear()
        env_counts = mask.sum(axis=0)
        # Hold grants while any env is shorter than a sample window (the
        # host buffer refuses to sample in that state). Under a
        # data-parallel group every rank's ring must be ready, or one rank
        # would enter the gradient step's collectives alone; the heads only
        # grow, so the group is asked until it first says yes.
        ready = bool((self.dev_valid + env_counts).min() >= self.seq_len)
        if self.grant_backlog > 0 and not self._group_ready:
            ready = self._group_ready = all_true(ready)
        chunk = min(self.grad_chunk, self.grant_backlog) if ready else 0
        validmask = np.zeros((self.grad_chunk,), np.float32)
        validmask[:chunk] = 1.0
        values.update(__mask__=mask, __pos__=self.dev_pos, __valid_n__=self.dev_valid, __validmask__=validmask)
        blob = pack_burst_blob(self._layouts[size], values, pin_memory=self.device.type == "cuda")
        self._metrics["insert_latency_s"] += time.perf_counter() - t0

        t1 = time.perf_counter()
        carry, self.rb_dev, metrics = self._burst_fn(carry, self.rb_dev, blob, self.generator)
        self._metrics["dispatch_latency_s"] += time.perf_counter() - t1

        self.dev_pos[:] = (self.dev_pos + env_counts) % self.capacity
        self.dev_valid[:] = np.minimum(self.dev_valid + env_counts, self.capacity)
        self.grant_backlog -= chunk
        self._metrics["flushes"] += 1
        self._metrics["bytes_staged"] += int(blob.numel())
        if chunk > 0:
            self.gradient_steps += chunk
            self.train_steps += 1
        return carry, chunk, (metrics if chunk > 0 else None)

    def pump(self, carry: Any) -> Tuple[Any, Any]:
        """One per-env-step dispatch (append + up to ``grad_chunk`` granted
        steps), plus append-free drains while a full chunk of backlog
        remains. Returns ``(carry, the last trained metrics or None)``, the
        metrics left on the device."""
        carry, chunk, metrics = self._flush(carry)
        while self.grant_backlog >= self.grad_chunk:
            carry, chunk, m = self._flush(carry)
            if m is not None:
                metrics = m
            if chunk == 0:
                break
        return carry, metrics

    # -- metrics and checkpoint --------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        return {
            "Replay/occupancy": float(self.dev_valid.sum()) / (self.capacity * self.n_envs),
            "Replay/size": int(self.dev_valid.sum()),
            "Replay/flushes": self._metrics["flushes"],
            "Replay/bytes_staged": self._metrics["bytes_staged"],
            "Replay/insert_latency_s": round(self._metrics["insert_latency_s"], 4),
            "Replay/dispatch_latency_s": round(self._metrics["dispatch_latency_s"], 4),
        }

    def state_dict(self, live: bool = False) -> DeviceReplayState:
        """A copy of the ring, its heads and its generator on the CPU; with
        ``live`` the ring's storage is the device tensors themselves, for a
        :class:`~sheeprl_tpu_torch.fault.CheckpointManager` to stage without
        blocking the host."""
        if self._staged:
            raise RuntimeError("checkpointing with staged-but-unflushed rows would drop them")
        arrays = {f"storage/{k}": v if live else v.to("cpu", copy=True) for k, v in self.rb_dev.items()}
        arrays["pos"] = torch.from_numpy(self.dev_pos.copy())
        arrays["valid"] = torch.from_numpy(self.dev_valid.copy())
        arrays["key"] = self.generator.get_state()
        meta = {"capacity": self.capacity, "n_envs": self.n_envs, "seq_len": self.seq_len}
        return DeviceReplayState("sequence", arrays, meta)

    def load_state_dict(self, snap: DeviceReplayState) -> "SequenceRingDriver":
        """Restore a sequence snapshot; one without a ``key`` (converted from
        the JAX package, whose key stream cannot be carried) leaves the
        generator as seeded."""
        if snap.kind != "sequence":
            raise ValueError(f"cannot restore a '{snap.kind}' replay snapshot into SequenceRingDriver")
        if snap.meta["capacity"] != self.capacity or snap.meta["n_envs"] != self.n_envs:
            raise ValueError(
                f"replay snapshot shape mismatch: checkpoint ({snap.meta['capacity']}, "
                f"{snap.meta['n_envs']}) vs configured ({self.capacity}, {self.n_envs})"
            )
        for k, store in self.rb_dev.items():
            store.copy_(snap.arrays[f"storage/{k}"])
        self.dev_pos = np.asarray(snap.arrays["pos"], np.int64).copy()
        self.dev_valid = np.asarray(snap.arrays["valid"], np.int64).copy()
        if "key" in snap.arrays:
            self.generator.set_state(snap.arrays["key"])
        return self


class AsyncSequenceRing:
    """Decoupled (Sebulba) per-env-head sequence ring for DreamerV3.

    Its state on the ring's device, :attr:`state`: the storage ``{key: (C, E,
    ...)}``, the per-env write heads ``pos`` and valid counts ``valid``
    (int32), which the append advances on the device; and the ring's
    ``torch.Generator`` on that device (the JAX ring's key stream), which the
    train dispatch draws from. Actors write their rows into append blobs
    (:class:`SeqBlobWriter`, or :meth:`pack_rows`, a pure function: nothing
    on ``self`` changes, so concurrent writers never race); the learner, the
    ring's only writer, commits each blob with one ragged multi-head scatter
    at the actor's env columns (:meth:`append`).

    The host keeps ``host_pos``/``host_valid`` mirrors, advanced from the
    queued item's per-env counts (:meth:`note_append`), for the grant gate
    (:meth:`ready`) and the ``Replay/*`` metrics; the card holds the truth,
    and nothing is read back from it."""

    def __init__(
        self,
        ring_keys: Dict[str, Tuple[tuple, Any]],
        capacity: int,
        n_envs: int,
        local_envs: int,
        seq_len: int,
        stage_rows: int,
        *,
        device: "torch.device | str" = "cpu",
        seed: int = 0,
    ) -> None:
        if n_envs % local_envs != 0:
            raise ValueError(
                f"ring env columns ({n_envs}) must be a multiple of the per-actor env batch ({local_envs})"
            )
        self.device = torch.device(device)
        self.ring_keys = {k: (tuple(int(s) for s in shape), np.dtype(dtype)) for k, (shape, dtype) in ring_keys.items()}
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.local_envs = int(local_envs)
        self.seq_len = int(seq_len)
        self.stage_rows = int(stage_rows)
        if self.stage_rows > self.capacity:
            raise ValueError(f"stage_rows ({self.stage_rows}) cannot exceed the ring capacity ({self.capacity})")
        self._append_fn, self.append_layout = build_seq_append_step(
            self.ring_keys, self.capacity, self.n_envs, self.local_envs, self.stage_rows
        )
        storage, _, _ = init_device_ring(self.ring_keys, self.capacity, self.n_envs, self.device)
        self.state: Dict[str, Any] = {
            "storage": storage,
            "pos": torch.zeros(self.n_envs, dtype=torch.int32, device=self.device),
            "valid": torch.zeros(self.n_envs, dtype=torch.int32, device=self.device),
        }
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.host_pos = np.zeros(self.n_envs, np.int64)
        self.host_valid = np.zeros(self.n_envs, np.int64)
        self._metrics = {"flushes": 0, "bytes_staged": 0, "dispatch_latency_s": 0.0}

    # -- actor side (pure) -------------------------------------------------------
    def pack_rows(self, rows: List[Tuple[Dict[str, np.ndarray], np.ndarray]], env_offset: int) -> torch.Tensor:
        """One actor's ``(row dict, env mask)`` pairs (regular all-env rows
        and ragged reset rows, each key ``(local_envs, ...)``) as ONE host
        append blob (pinned for a CUDA ring). ``env_offset`` is the actor's
        first env column in the ring."""
        if len(rows) > self.stage_rows:
            raise ValueError(f"{len(rows)} rows exceed the append blob capacity (stage_rows={self.stage_rows})")
        values: Dict[str, np.ndarray] = {}
        for k, (shape, dtype) in self.ring_keys.items():
            arr = np.zeros((self.stage_rows, self.local_envs) + shape, dtype)
            for i, (row, _m) in enumerate(rows):
                arr[i] = np.asarray(row[k], dtype=dtype).reshape((self.local_envs,) + shape)
            values[k] = arr
        mask = np.zeros((self.stage_rows, self.local_envs), np.int32)
        for i, (_r, m) in enumerate(rows):
            mask[i] = m
        values["__mask__"] = mask
        values["__offset__"] = np.asarray(int(env_offset), np.int32)
        return pack_burst_blob(self.append_layout, values, pin_memory=self.device.type == "cuda")

    # -- learner side ------------------------------------------------------------
    def append(self, blob: torch.Tensor, env_offset: int) -> None:
        """Commit one append blob (on the ring's device) at the actor's first
        env column ``env_offset``, a host ``int`` from the queued item: one
        ragged multi-head scatter on the current stream. Advance the host
        mirrors with :meth:`note_append`."""
        t0 = time.perf_counter()
        self._append_fn(self.state, blob, int(env_offset))
        self._metrics["dispatch_latency_s"] += time.perf_counter() - t0

    def note_append(self, env_counts: np.ndarray, blob_bytes: int) -> None:
        """Advance the host head mirrors for one committed blob by its
        per-env row counts (``(n_envs,)``, zero outside the actor's slice)."""
        counts = np.asarray(env_counts, np.int64)
        self.host_pos[:] = (self.host_pos + counts) % self.capacity
        self.host_valid[:] = np.minimum(self.host_valid + counts, self.capacity)
        self._metrics["flushes"] += 1
        self._metrics["bytes_staged"] += int(blob_bytes)

    def ready(self) -> bool:
        """Grant gate: every env column holds at least one sample window."""
        return bool(self.host_valid.min() >= self.seq_len)

    def metrics(self) -> Dict[str, float]:
        return {
            "Replay/occupancy": float(self.host_valid.sum()) / (self.capacity * self.n_envs),
            "Replay/size": int(self.host_valid.sum()),
            "Replay/flushes": self._metrics["flushes"],
            "Replay/bytes_staged": self._metrics["bytes_staged"],
            "Replay/dispatch_latency_s": round(self._metrics["dispatch_latency_s"], 4),
        }

    # -- checkpoint --------------------------------------------------------------
    def state_dict(self, live: bool = False) -> DeviceReplayState:
        """The storage, the device heads and the generator's state; copies on
        the CPU, or with ``live`` the device tensors themselves, for a
        :class:`~sheeprl_tpu_torch.fault.CheckpointManager` to stage without
        blocking the host."""
        def out(v: torch.Tensor) -> torch.Tensor:
            return v if live else v.to("cpu", copy=True)

        arrays = {f"storage/{k}": out(v) for k, v in self.state["storage"].items()}
        arrays["pos"] = out(self.state["pos"])
        arrays["valid"] = out(self.state["valid"])
        arrays["key"] = self.generator.get_state()
        meta = {"capacity": self.capacity, "n_envs": self.n_envs, "seq_len": self.seq_len}
        return DeviceReplayState("sequence", arrays, meta)

    def load_state_dict(self, snap: DeviceReplayState) -> "AsyncSequenceRing":
        """Restore a sequence snapshot (this ring's, or one converted from the
        JAX package, which has no ``key``: the generator then stays as
        seeded)."""
        if snap.kind != "sequence":
            raise ValueError(f"cannot restore a '{snap.kind}' replay snapshot into AsyncSequenceRing")
        if snap.meta["capacity"] != self.capacity or snap.meta["n_envs"] != self.n_envs:
            raise ValueError(
                f"replay snapshot shape mismatch: checkpoint ({snap.meta['capacity']}, "
                f"{snap.meta['n_envs']}) vs configured ({self.capacity}, {self.n_envs})"
            )
        for k, store in self.state["storage"].items():
            store.copy_(snap.arrays[f"storage/{k}"])
        self.state["pos"].copy_(torch.as_tensor(snap.arrays["pos"]).to(torch.int32))
        self.state["valid"].copy_(torch.as_tensor(snap.arrays["valid"]).to(torch.int32))
        self.host_pos = np.asarray(snap.arrays["pos"], np.int64).copy()
        self.host_valid = np.asarray(snap.arrays["valid"], np.int64).copy()
        if "key" in snap.arrays:
            self.generator.set_state(snap.arrays["key"])
        return self


class _Slab(dict):
    """One host slab of an append blob: numpy views into one contiguous byte
    tensor (pinned for a CUDA ring), and the event of its last upload."""

    def __init__(self, layout: BlobLayout, pinned: bool, env_offset: int) -> None:
        blob = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=pinned)
        raw = blob.numpy()
        super().__init__({
            name: raw[off : off + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
            for name, off, shape, dtype in layout.segments
        })
        self["__offset__"][...] = int(env_offset)
        self.blob = blob
        self.event: Optional[torch.cuda.Event] = None


class SeqBlobWriter:
    """Write-through staging of ONE actor's append blobs.

    The actor's env loop writes each row straight into a host slab's views
    (no per-step row dicts, no pack-time copy). Unwritten row slots keep
    stale bytes from an earlier block: a slot's mask is zeroed when its slab
    is begun, and the append drops every cell whose mask is 0.

    :meth:`ship` sends the slab to the ring's device in ONE non-blocking copy
    on the caller's stream and records an event after it; a slab is refilled
    only after its own upload's event has completed (the
    ``DoubleBufferedStager`` rule), so rotating never overwrites a blob whose
    copy is in flight. On the CPU :meth:`ship` hands over a copy of the slab,
    which the learner owns."""

    def __init__(self, ring: AsyncSequenceRing, env_offset: int, slots: int = 2) -> None:
        if slots < 2:
            raise ValueError(f"the writer needs at least 2 slabs, got {slots}")
        self.layout = ring.append_layout
        self.local_envs = ring.local_envs
        self.stage_rows = ring.stage_rows
        self.device = ring.device
        self.env_offset = int(env_offset)
        self._slabs = [_Slab(self.layout, self.device.type == "cuda", self.env_offset) for _ in range(int(slots))]
        self._idx = 0
        self._slab: Optional[_Slab] = None
        self._n = 0
        self.begin()

    def begin(self) -> None:
        """Start filling the next slab: first wait until its last upload has
        run, then zero its masks and reset the row cursor."""
        slab = self._slabs[self._idx]
        self._idx = (self._idx + 1) % len(self._slabs)
        if slab.event is not None:
            slab.event.synchronize()
            slab.event = None
        slab["__mask__"][:] = 0
        self._slab, self._n = slab, 0

    @property
    def rows(self) -> int:
        return self._n

    def row(self, env_mask) -> Dict[str, np.ndarray]:
        """Claim the next row slot: sets its write mask and returns per-key
        ``(local_envs, ...)`` views to write the row's data into."""
        if self._n >= self.stage_rows:
            raise RuntimeError(f"append blob holds {self.stage_rows} row slot(s); ship before staging more")
        i = self._n
        self._n += 1
        self._slab["__mask__"][i] = env_mask
        return {k: v[i] for k, v in self._slab.items() if not k.startswith("__")}

    def ship(self) -> Tuple[torch.Tensor, np.ndarray]:
        """Finish the blob: ``(the blob on the ring's device, per-local-env
        row counts)``, then begin the next slab."""
        slab = self._slab
        counts = slab["__mask__"].sum(axis=0).astype(np.int64)
        if self.device.type == "cuda":
            blob = slab.blob.to(self.device, non_blocking=True)
            slab.event = torch.cuda.Event()
            slab.event.record(torch.cuda.current_stream(self.device))
        else:
            blob = slab.blob.clone()
        self.begin()
        return blob, counts
