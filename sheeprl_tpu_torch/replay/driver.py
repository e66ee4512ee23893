"""Synchronous device-resident sequence replay for DreamerV3's coupled loop
(counterpart of ``SequenceRingDriver`` in ``sheeprl_tpu/replay/driver.py``).

The player stays where it is, and every env step dispatches ONE burst: the
append of the staged transitions, then the granted gradient steps with their
windows drawn on the device. No host sampling, no per-step batch upload.

The caller (the algorithm's main) owns the training carry, the grant feed
(``Ratio``) and logging; the driver owns the ring, the staging, the packed
upload, the grant backlog, the ring's generator and the checkpointable ring
state. The heads are host mirrors, advanced from what the host staged,
never read back from the card. The decoupled ring (``AsyncSequenceRing``)
waits for a later slice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.ring import make_blob_layouts, pack_burst_blob
from sheeprl_tpu_torch.replay.device_buffer import DeviceReplayState
from sheeprl_tpu_torch.utils.burst import init_device_ring

__all__ = ["SequenceRingDriver"]

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
        # host buffer refuses to sample in that state).
        ready = (self.dev_valid + env_counts).min() >= self.seq_len
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
