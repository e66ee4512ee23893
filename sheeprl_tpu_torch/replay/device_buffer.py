"""Device-resident replay buffer: a ring of tensors in card memory that the
train step appends to and samples from on the device (counterpart of
``sheeprl_tpu/replay/device_buffer.py``, one card).

The env loop stages one transition row on the host and flushes it as ONE
packed uint8 blob per env step (:mod:`sheeprl_tpu_torch.data.ring`): one
pinned host tensor and one non-blocking host->device copy. The SAC step
scatters the row into the ring, draws its minibatches on the device
(uniform over the valid ``(position, env)`` grid, or proportional through
the sum-tree and the CUDA ``sumtree_sample`` kernel), trains, and writes the
new priorities back, without a read back to the host.

Layout and ownership:

- storage ``{key: (capacity, n_envs, *feat)}`` on the device, updated in
  place;
- with PER, the ``(2P,)`` sum-tree over the ``capacity * n_envs`` row-major
  ``(row, env)`` leaves and the running maximum priority ``max_p``, both on
  the device;
- the train draws' generator (the JAX ring's key stream), on the device;
- the write head (``pos``/``valid``) as host integers: the host knows every
  append, so nothing needs the device's copy.

The decoupled (Sebulba) topology splits the flush and the dispatch: actor
threads pack up to ``stage_rows`` rows each into one append blob
(:meth:`DeviceReplayBuffer.pack_rows`, a pure function of its rows) and stage
it from their own thread; the learner, the ring's only writer, appends each
blob (:meth:`DeviceReplayBuffer.make_append_step`), advances the host head
(:meth:`DeviceReplayBuffer.note_append`) and trains from a control job
(:meth:`DeviceReplayBuffer.make_ctl_job`) through the append-free variant of
``algos/sac/sac.py:make_resident_train_step``.

Checkpointing: :meth:`state_dict` copies everything to the CPU inside a
:class:`DeviceReplayState` (:meth:`DeviceReplayState.to_dict` is what the
checkpoint stores: tensors and plain values only), :meth:`load_state_dict`
copies it back. :func:`restore_host_buffer` fills a host
:class:`~sheeprl_tpu_torch.data.ReplayBuffer` from one, and
:meth:`DeviceReplayBuffer.load_host_buffer` the ring from a host buffer (the
crossovers between the two tiers). :func:`resolve_device_resident` sizes the
ring against ``buffer.hbm_budget_gb``; a uniform ring that does not fit
spills over to the host buffer, a prioritized one raises (the host tier has
no PER).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.ring import BlobLayout, make_layout, pack_burst_blob, torch_dtype, unpack_burst_blob
from sheeprl_tpu_torch.replay import sumtree

__all__ = [
    "ControlJob",
    "DeviceReplayBuffer",
    "DeviceReplayState",
    "ReplayJob",
    "estimate_ring_bytes",
    "resolve_device_resident",
    "restore_host_buffer",
    "restore_host_env_buffer",
]


def estimate_ring_bytes(
    specs: Dict[str, Tuple[tuple, Any]],
    capacity: int,
    n_envs: int,
    prioritized: bool = False,
    sequence: Optional[Dict[str, int]] = None,
    world: int = 1,
) -> int:
    """Device bytes of a ring with the given storage spec (plus the sum-tree
    with PER).

    ``sequence`` (``{"seq_len": T, "batch_size": B}``) switches on the
    per-env-head sequence-ring accounting (the Dreamer shape): beyond the
    storage rows, the per-env heads and a train key (the JAX package's
    count, kept so the two agree), the ``(capacity, n_envs)`` int32 window
    validity working set, and the gathered ``(T, B)`` window in float32,
    the part that bites for a pixel ring.

    ``world`` is the data-parallel group's size, ``n_envs`` one rank's envs:
    a prioritized ring is replicated, every rank holding the group's
    ``world * n_envs`` columns and their tree (JAX's replicated PER ring); a
    uniform or sequence ring holds the rank's own columns (JAX's env-sharded
    ring, one device a process) and a sequence ring gathers the rank's
    ``batch_size // world`` windows."""
    if prioritized:
        n_envs = n_envs * int(world)
    total = 0
    row_bytes_f32 = 0
    for shape, dtype in specs.values():
        feat = int(np.prod(shape or (1,)))
        total += capacity * n_envs * feat * np.dtype(dtype).itemsize
        row_bytes_f32 += feat * 4
    if prioritized:
        total += 2 * sumtree.leaf_count(capacity * n_envs) * 4
    if sequence is not None:
        total += n_envs * 2 * 4 + 8
        total += capacity * n_envs * 4
        total += int(sequence["seq_len"]) * (int(sequence["batch_size"]) // max(1, int(world))) * row_bytes_f32
    return int(total)


def resolve_device_resident(
    setting: Any,
    specs: Dict[str, Tuple[tuple, Any]],
    capacity: int,
    n_envs: int,
    hbm_budget_gb: float,
    prioritized: bool = False,
    sequence: Optional[Dict[str, int]] = None,
    world: int = 1,
) -> Tuple[bool, str]:
    """``(use_device, reason)`` for the ``buffer.device_resident`` knob:
    ``False`` | ``True`` | ``"auto"``. ``auto`` puts the ring on the device
    iff it fits ``hbm_budget_gb``; an explicit ``True`` that does not fit
    spills over to the host buffer with a warning instead of running out of
    memory at allocation. A prioritized ring that does not fit raises: the
    host buffer samples uniformly, so spilling would change the algorithm
    (the JAX package spills it all the same). ``sequence`` sizes a Dreamer
    sequence ring (:func:`estimate_ring_bytes`); ``world`` is the
    data-parallel group's size (JAX's device count), ``n_envs`` one rank's
    envs."""
    if isinstance(setting, str):
        setting = setting.strip().lower()
        if setting not in ("auto", "true", "false"):
            raise ValueError(f"buffer.device_resident must be true/false/auto, got '{setting}'")
        setting = {"auto": "auto", "true": True, "false": False}[setting]
    if setting is False:
        return False, "disabled by config"
    budget = float(hbm_budget_gb) * (1 << 30)
    est = estimate_ring_bytes(specs, capacity, n_envs, prioritized, sequence=sequence, world=world)
    if est <= budget:
        return True, f"ring fits HBM budget ({est / 2**20:.1f} MiB <= {hbm_budget_gb} GiB)"
    need = f"device ring would need {est / 2**30:.2f} GiB (budget buffer.hbm_budget_gb={hbm_budget_gb})"
    if prioritized:
        raise ValueError(f"buffer.priority.enabled=true but the {need}; the host buffer has no PER")
    reason = f"{need}; spilling to the host buffer"
    if setting is True:
        warnings.warn(f"buffer.device_resident=true but {reason}")
    return False, reason


class DeviceReplayState:
    """CPU snapshot of a device ring: ``arrays`` (CPU tensors: ``storage/<key>``,
    ``pos``, ``valid``, ``key`` = the generator state, and with PER ``tree``
    and ``max_p``) and ``meta`` (plain values)."""

    def __init__(self, kind: str, arrays: Dict[str, torch.Tensor], meta: Dict[str, Any]) -> None:
        self.kind = kind
        self.arrays = arrays
        self.meta = meta

    def to_dict(self) -> Dict[str, Any]:
        """What a checkpoint stores (loads with ``weights_only``)."""
        return {"kind": self.kind, "arrays": dict(self.arrays), "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DeviceReplayState":
        return cls(data["kind"], dict(data["arrays"]), dict(data["meta"]))


class ReplayJob(NamedTuple):
    """One flush: the staged row on the device (None when nothing was
    staged: a backlog-drain dispatch), where it goes, and the valid rows
    after it lands."""

    blob: Optional[torch.Tensor]
    pos: int
    count: int
    valid: int


class ControlJob(NamedTuple):
    """One append-free train dispatch (JAX's control blob, ``__flags__``,
    ``__valid__`` and ``__beta__``, kept on the host: the port's dispatch
    loops over its steps in Python): each granted step's EMA flag, PER's
    beta, and the valid rows of the ring the steps draw from."""

    flags: Tuple[float, ...]
    beta: float
    valid: int


class DeviceReplayBuffer:
    """Scalar-write-head device ring with uniform or PER sampling (the
    SAC-shaped buffer). The class owns allocation, host staging and the
    packed flush, the append, checkpoint state and ``Replay/*`` metrics;
    the sampling is the train step's (``algos/sac/sac.py``)."""

    def __init__(
        self,
        specs: Dict[str, Tuple[tuple, Any]],
        capacity: int,
        n_envs: int,
        *,
        device: "torch.device | str" = "cpu",
        prioritized: bool = False,
        per_alpha: float = 0.6,
        per_eps: float = 1e-6,
        seed: int = 0,
        stage_rows: int = 1,
    ) -> None:
        if capacity <= 0 or n_envs <= 0:
            raise ValueError(f"need positive capacity/n_envs (got {capacity}, {n_envs})")
        if stage_rows > capacity:
            raise ValueError(f"stage_rows ({stage_rows}) cannot exceed the ring capacity ({capacity})")
        self.device = torch.device(device)
        self.specs = {k: (tuple(int(s) for s in shape), np.dtype(dtype)) for k, (shape, dtype) in specs.items()}
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.prioritized = bool(prioritized)
        self.per_alpha = float(per_alpha)
        self.per_eps = float(per_eps)
        self.tree_leaves = sumtree.leaf_count(self.capacity * self.n_envs) if prioritized else 0
        # one staged row per flush, packed into one upload
        self.layout: BlobLayout = make_layout([(k, (1, self.n_envs) + shape, dtype) for k, (shape, dtype) in self.specs.items()])
        # up to stage_rows rows and their count: the decoupled topology's
        # blob, and with stage_rows > 1 the staging area's flush
        self.stage_rows = int(stage_rows)
        self.append_layout: BlobLayout = make_layout(
            [(k, (self.stage_rows, self.n_envs) + shape, dtype) for k, (shape, dtype) in self.specs.items()]
            + [("__count__", (), np.int32)]
        )

        self.storage = {
            k: torch.zeros((self.capacity, self.n_envs) + shape, dtype=torch_dtype(dtype), device=self.device)
            for k, (shape, dtype) in self.specs.items()
        }
        self.tree = sumtree.init(self.capacity * self.n_envs, self.device) if prioritized else None
        self.max_p = torch.ones((), dtype=torch.float32, device=self.device) if prioritized else None
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._env_leaves = torch.arange(self.n_envs, device=self.device)

        self._pos = 0
        self._full = False
        self._staged: List[Dict[str, np.ndarray]] = []
        self._metrics = {"flushes": 0, "inserts": 0}

    # -- properties ----------------------------------------------------------
    @property
    def full(self) -> bool:
        return self._full

    @property
    def pos(self) -> int:
        return self._pos

    @property
    def valid_rows(self) -> int:
        return self.capacity if self._full else self._pos

    # -- staging, flush and append ---------------------------------------------
    def add(self, step_data: Dict[str, np.ndarray]) -> None:
        """Stage one ``(1, n_envs, ...)`` transition row for the next flush
        (up to ``stage_rows`` of them)."""
        if len(self._staged) >= self.stage_rows:
            held = "one row" if self.stage_rows == 1 else f"{self.stage_rows} rows"
            raise RuntimeError(f"the staging area holds {held}; flush (make_job) before adding another")
        self._staged.append({
            k: np.asarray(step_data[k], dtype=dtype).reshape((1, self.n_envs) + shape)
            for k, (shape, dtype) in self.specs.items()
        })
        self._metrics["inserts"] += self.n_envs

    def make_job(self) -> ReplayJob:
        """Pack the staged rows (if any: a backlog-drain dispatch appends
        nothing) into one blob, start its non-blocking copy to the device and
        advance the host head. One staged row packs into :attr:`layout`;
        with ``stage_rows`` > 1 they pack into :attr:`append_layout`."""
        pos, count = self._pos, len(self._staged)
        blob = None
        if count:
            if self.stage_rows == 1:
                host = pack_burst_blob(self.layout, self._staged[0], pin_memory=self.device.type == "cuda")
            else:
                host = self.pack_rows([{k: v[0] for k, v in row.items()} for row in self._staged])
            blob = host.to(self.device, non_blocking=True)
            self._staged = []
            if self._pos + count >= self.capacity:
                self._full = True
            self._pos = (self._pos + count) % self.capacity
        self._metrics["flushes"] += 1
        return ReplayJob(blob, pos, count, self.valid_rows)

    def append(self, job: ReplayJob) -> None:
        """Scatter the job's rows into the ring from its position, wrapping;
        with PER their fresh leaves enter at the running maximum priority."""
        if not job.count:
            return
        if self.stage_rows > 1:
            self._scatter_rows(unpack_burst_blob(job.blob, self.append_layout), job.count, job.pos)
            return
        rows = unpack_burst_blob(job.blob, self.layout)
        for k, store in self.storage.items():
            store[job.pos] = rows[k][0]
        if self.prioritized:
            sumtree.update(self.tree, job.pos * self.n_envs + self._env_leaves, self.max_p.expand(self.n_envs))

    def _scatter_rows(self, rows: Dict[str, torch.Tensor], count: int, pos: int) -> None:
        """The first ``count`` rows of an :attr:`append_layout` blob into the
        ring from ``pos``, wrapping, one ``index_copy_`` per key."""
        idx = (torch.arange(count, device=self.device) + pos) % self.capacity
        for k, store in self.storage.items():
            store.index_copy_(0, idx, rows[k][:count])
        if self.prioritized:
            leaves = (idx[:, None] * self.n_envs + self._env_leaves[None, :]).reshape(-1)
            sumtree.update(self.tree, leaves, self.max_p.expand(count * self.n_envs))

    # -- decoupled (Sebulba) append/train pair ---------------------------------
    def pack_rows(self, rows: Sequence[Dict[str, np.ndarray]]) -> torch.Tensor:
        """Up to ``stage_rows`` transition rows (each key ``(n_envs, ...)``)
        as one host append blob (pinned for a CUDA ring), rows past their
        count zero. A pure function of ``rows``: nothing of the buffer
        changes, so concurrent actors may each pack their own and stage it
        from their thread; the learner advances the head
        (:meth:`note_append`) when it appends one."""
        if len(rows) > self.stage_rows:
            raise ValueError(f"{len(rows)} rows exceed the append blob capacity (stage_rows={self.stage_rows})")
        values: Dict[str, np.ndarray] = {}
        for k, (shape, dtype) in self.specs.items():
            arr = np.zeros((self.stage_rows, self.n_envs) + shape, dtype)
            for i, row in enumerate(rows):
                arr[i] = np.asarray(row[k], dtype=dtype).reshape((self.n_envs,) + shape)
            values[k] = arr
        values["__count__"] = np.asarray(len(rows), np.int32)
        return pack_burst_blob(self.append_layout, values, pin_memory=self.device.type == "cuda")

    def note_append(self, count: int) -> None:
        """Advance the host head for one appended blob of ``count`` rows."""
        count = int(count)
        if count <= 0:
            return
        if self._pos + count >= self.capacity:
            self._full = True
        self._pos = (self._pos + count) % self.capacity
        self._metrics["flushes"] += 1
        self._metrics["inserts"] += count * self.n_envs

    def make_ctl_job(self, flags: Sequence[float], beta: float = 0.0) -> ControlJob:
        """An append-free dispatch's control: the granted steps' EMA flags
        and PER's beta over the rows now stored."""
        return ControlJob(tuple(float(f) for f in flags), float(beta), self.valid_rows)

    def make_append_step(self) -> Callable[[torch.Tensor, int], None]:
        """The decoupled topology's append: ``append(blob, count)`` scatters
        the first ``count`` rows of a :meth:`pack_rows` blob (on the ring's
        device) at the write head, wrapping, in one ``index_copy_`` per key;
        the rows past ``count`` are dropped. With PER each fresh ``(row,
        env)`` leaf enters the sum-tree at ``max_p``. Call
        :meth:`note_append` after it: the head is the host's."""
        layout = self.append_layout

        def append(blob: torch.Tensor, count: int) -> None:
            count = int(count)
            if count > 0:
                self._scatter_rows(unpack_burst_blob(blob, layout), count, self._pos)

        return append

    def metrics(self) -> Dict[str, float]:
        """``Replay/*`` metrics."""
        return {
            "Replay/occupancy": self.valid_rows / self.capacity,
            "Replay/size": self.valid_rows * self.n_envs,
            "Replay/flushes": self._metrics["flushes"],
            "Replay/inserts": self._metrics["inserts"],
        }

    def digest(self) -> str:
        """sha256 of the ring's storage, heads, and with PER its tree and
        ``max_p``, in order: equal digests are bit-equal rings (a
        data-parallel group's replicated prioritized rings must be)."""
        import hashlib

        h = hashlib.sha256()
        tensors = [self.storage[k] for k in sorted(self.storage)]
        if self.prioritized:
            tensors += [self.tree, self.max_p]
        for t in tensors:
            h.update(t.detach().to("cpu").contiguous().numpy().tobytes())
        h.update(f"{self._pos},{self.valid_rows}".encode())
        return h.hexdigest()

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self, live: bool = False) -> DeviceReplayState:
        """A copy of everything on the CPU; with ``live`` the storage, the
        tree and ``max_p`` are the device tensors themselves, for a
        :class:`~sheeprl_tpu_torch.fault.CheckpointManager` to stage without
        blocking the host. Call with an empty staging area (the loop flushes
        every env step)."""
        if self._staged:
            raise RuntimeError("checkpointing with a staged but unflushed row would drop it")

        def out(v: torch.Tensor) -> torch.Tensor:
            return v if live else v.to("cpu", copy=True)

        arrays = {f"storage/{k}": out(v) for k, v in self.storage.items()}
        arrays["pos"] = torch.tensor(self._pos, dtype=torch.int32)
        arrays["valid"] = torch.tensor(self.valid_rows, dtype=torch.int32)
        arrays["key"] = self.generator.get_state()
        if self.prioritized:
            arrays["tree"] = out(self.tree)
            arrays["max_p"] = out(self.max_p)
        meta = {
            "capacity": self.capacity,
            "n_envs": self.n_envs,
            "prioritized": self.prioritized,
            "host_pos": self._pos,
            "host_full": self._full,
            "metrics": dict(self._metrics),
        }
        return DeviceReplayState("uniform", arrays, meta)

    def load_state_dict(self, snap: DeviceReplayState) -> "DeviceReplayBuffer":
        if snap.kind != "uniform":
            raise ValueError(f"cannot restore a '{snap.kind}' replay snapshot into DeviceReplayBuffer")
        if snap.meta["capacity"] != self.capacity or snap.meta["n_envs"] != self.n_envs:
            raise ValueError(
                f"replay snapshot shape mismatch: checkpoint ({snap.meta['capacity']}, "
                f"{snap.meta['n_envs']}) vs configured ({self.capacity}, {self.n_envs})"
            )
        for k, store in self.storage.items():
            store.copy_(snap.arrays[f"storage/{k}"])
        self.generator.set_state(snap.arrays["key"])
        if self.prioritized:
            if "tree" in snap.arrays:
                self.tree.copy_(snap.arrays["tree"])
                self.max_p.copy_(snap.arrays["max_p"])
            else:  # a uniform ring resumed with PER: every filled slot at priority 1
                self._uniform_priorities(int(snap.meta["capacity"] if snap.meta["host_full"] else snap.meta["host_pos"]))
        self._pos = int(snap.meta["host_pos"])
        self._full = bool(snap.meta["host_full"])
        self._metrics.update(snap.meta.get("metrics", {}))
        return self

    def _uniform_priorities(self, valid: int) -> None:
        # row-major (row, env) leaves: rows [0, valid) are the first valid * n_envs leaves
        self.tree.zero_()
        self.tree[self.tree_leaves : self.tree_leaves + valid * self.n_envs] = 1.0
        sumtree.rebuild(self.tree)
        self.max_p.fill_(1.0)

    def load_host_buffer(self, rb) -> "DeviceReplayBuffer":
        """Copy a restored host ``ReplayBuffer`` into the ring (resuming a
        host-tier checkpoint into the device tier). PER priorities are not in
        the host checkpoint, so filled slots restart at priority 1."""
        if rb.empty:
            return self
        if len(rb) != self.capacity or rb.n_envs != self.n_envs:
            raise ValueError(
                f"host buffer shape ({len(rb)}, {rb.n_envs}) does not match the device ring ({self.capacity}, {self.n_envs})"
            )
        for k, (shape, dtype) in self.specs.items():
            host = np.asarray(rb.buffer[k], dtype=dtype).reshape((self.capacity, self.n_envs) + shape)
            self.storage[k].copy_(torch.from_numpy(host))
        self._pos, self._full = int(rb.pos), bool(rb.full)
        if self.prioritized:
            self._uniform_priorities(self.valid_rows)
        return self


def restore_host_buffer(
    snap: DeviceReplayState, rb, fill_missing: Optional[Dict[str, Tuple[tuple, Any]]] = None
) -> None:
    """Fill a host ``ReplayBuffer`` from a device-ring snapshot (resuming
    into the host tier). ``fill_missing`` zero-allocates keys the host loop
    writes but the ring never stored (SAC's ``truncated``), so later
    ``add`` calls find every key."""
    if snap.kind != "uniform":
        raise ValueError(f"cannot restore a '{snap.kind}' replay snapshot into a flat host buffer")
    cap, n_envs = int(snap.meta["capacity"]), int(snap.meta["n_envs"])
    if cap != len(rb) or n_envs != rb.n_envs:
        raise ValueError(f"replay snapshot shape ({cap}, {n_envs}) does not match the host buffer ({len(rb)}, {rb.n_envs})")
    for name, arr in snap.arrays.items():
        if name.startswith("storage/"):
            rb.set_key(name[len("storage/") :], arr.numpy().copy())
    for k, (shape, dtype) in (fill_missing or {}).items():
        if k not in rb.buffer:
            rb.set_key(k, np.zeros((cap, n_envs) + tuple(shape), dtype))
    rb.set_head(int(snap.meta["host_pos"]), bool(snap.meta["host_full"]))


def restore_host_env_buffer(
    snap: DeviceReplayState, rb, fill_missing: Optional[Dict[str, Tuple[tuple, Any]]] = None
) -> None:
    """Fill a host ``EnvIndependentReplayBuffer`` from a sequence-ring
    snapshot (resuming a device-ring checkpoint on the host tier). Each
    env's column becomes its buffer's storage and the per-env write heads
    carry over, so window sampling resumes with the same validity.
    ``fill_missing`` zero-allocates keys the host loop writes but the ring
    never stored (``truncated``)."""
    if snap.kind != "sequence":
        raise ValueError(f"cannot restore a '{snap.kind}' replay snapshot into per-env host buffers")
    cap, n_envs = int(snap.meta["capacity"]), int(snap.meta["n_envs"])
    if cap != rb.buffer_size or n_envs != rb.n_envs:
        raise ValueError(
            f"replay snapshot shape ({cap}, {n_envs}) does not match the host buffer ({rb.buffer_size}, {rb.n_envs})"
        )
    pos = np.asarray(snap.arrays["pos"])
    valid = np.asarray(snap.arrays["valid"])
    for e, sub in enumerate(rb.buffer):
        for name, arr in snap.arrays.items():
            if name.startswith("storage/"):
                sub.set_key(name[len("storage/") :], arr[:, e : e + 1].numpy().copy())
        for k, (shape, dtype) in (fill_missing or {}).items():
            if k not in sub.buffer:
                sub.set_key(k, np.zeros((cap, 1) + tuple(shape), dtype))
        sub.set_head(int(pos[e]), bool(valid[e] >= cap))
