"""The hybrid host player and its trainer-thread burst dispatch
(counterpart of ``sheeprl_tpu/utils/burst.py``: the ``algo.hybrid_player``
machinery of the DreamerV3 and SAC loops).

The env loop's policy runs on the host CPU from a copy of the player's
parameters, while a trainer thread appends the staged transitions to the
sequence ring on the card and runs the granted gradient steps there, a burst
at a time. Pieces:

- :func:`dreamer_ring_keys`, :func:`init_device_ring`: the ring's storage
  spec and allocation (shared with the resident driver).
- :class:`HostSnapshot`: the player's parameter subset packed into ONE fresh
  tensor on the card in the wire dtype (bf16 for the Dreamer harness,
  float32 for SAC's actor), copied into pinned host memory without blocking
  on the trainer's stream, and unpacked to float32 into the CPU copy of the
  player's modules once the copy's event has completed. The packed tensor is
  new, so the trainer's in-place Adam steps never reach it.
- :class:`TrainerThread`: a bounded job queue feeding a supervised worker;
  the queue bound is the back-pressure. The port's step updates modules and
  optimizer state in place (JAX's is functional over its carry), so a step
  that dies after it started would leave part of a burst applied; with a
  :class:`TrainStateCopy` the worker copies the train state before each
  burst and puts it back before it retries one.
- :class:`BurstRunner`: staging rows, the packed pinned upload per flush and
  the grant gate, over ``data/ring.py:build_burst_train_step``.
- :class:`HybridPlayerHarness`: the whole path for a Dreamer main.

The trainer thread launches on the device's current stream, the one the
main thread's checkpoint copies and the final test episode also use, so a
read the main thread enqueues under :attr:`TrainerThread.train_lock` sees
the state between two bursts, never one half applied.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.ring import BlobLayout, effective_stage_buckets, make_blob_layouts, torch_dtype

__all__ = [
    "DREAMER_METRIC_NAMES",
    "BurstRunner",
    "HostCopies",
    "HostSnapshot",
    "HybridPlayerHarness",
    "TrainStateCopy",
    "TrainerThread",
    "dreamer_ring_keys",
    "dreamer_stage_sizes",
    "init_device_ring",
]

# Order matches the metrics every DreamerV3 gradient step returns.
DREAMER_METRIC_NAMES = (
    "Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/kl", "State/post_entropy",
    "State/prior_entropy", "Loss/policy_loss", "Loss/value_loss",
)


def dreamer_stage_sizes(train_every: int, n_envs: int, buffer_size: int) -> Tuple[int, Tuple[int, int]]:
    """Staging-row capacity and flush-upload buckets of the Dreamer burst
    path: a flush normally carries ``train_every`` step rows plus the odd
    ragged reset row, so the first bucket covers the common case, and the
    cap leaves 4x headroom for a backed-up trainer queue."""
    slack = n_envs + 2
    stage_max = min(4 * train_every + slack, buffer_size)
    return stage_max, (train_every + slack, 2 * train_every + slack)


def dreamer_ring_keys(
    observation_space: Mapping[str, Any], cnn_keys, mlp_keys, actions_dim, with_is_first: bool
) -> Dict[str, Tuple[tuple, Any]]:
    """Ring storage spec for a Dreamer family, in the JAX package's key
    order: pixel keys stay uint8 on the card, vectors, actions, rewards and
    ``terminated`` are float32; ``is_first`` only for the families whose
    dynamic rollout reads it (V2/V3). ``observation_space`` is the run
    config's ``spaces.obs`` block (``{key: {"shape": [...]}}``)."""
    specs: Dict[str, Tuple[tuple, Any]] = {}
    for k in cnn_keys:
        specs[k] = (tuple(int(s) for s in observation_space[k]["shape"]), np.dtype(np.uint8))
    for k in mlp_keys:
        specs[k] = (tuple(int(s) for s in observation_space[k]["shape"]), np.dtype(np.float32))
    specs["actions"] = ((int(np.sum(actions_dim)),), np.dtype(np.float32))
    specs["rewards"] = ((1,), np.dtype(np.float32))
    specs["terminated"] = ((1,), np.dtype(np.float32))
    if with_is_first:
        specs["is_first"] = ((1,), np.dtype(np.float32))
    return specs


def init_device_ring(ring_keys: Dict[str, Tuple[tuple, Any]], capacity: int, n_envs: int, device, rb=None):
    """Allocate the ring ``{key: (capacity, n_envs, *shape)}`` on ``device``,
    zeroed where it is made (never built on the host and copied over), or,
    given per-env host buffers ``rb`` (an ``EnvIndependentReplayBuffer``
    restored from a checkpoint), filled from them: each key is assembled on
    the host and copied in one transfer. Returns ``(rb_dev, pos, valid)``,
    the heads as host int64 arrays."""
    dev_pos = np.zeros(n_envs, np.int64)
    dev_valid = np.zeros(n_envs, np.int64)
    rb_dev = {}
    for k, (shape, dtype) in ring_keys.items():
        if rb is None:
            rb_dev[k] = torch.zeros((capacity, n_envs) + tuple(shape), dtype=torch_dtype(dtype), device=device)
            continue
        host = np.zeros((capacity, n_envs) + tuple(shape), np.dtype(dtype))
        for e, sub in enumerate(rb.buffer):
            if k in sub.buffer:
                host[:, e] = np.asarray(sub.buffer[k][:, 0], dtype=host.dtype)
        rb_dev[k] = torch.from_numpy(host).to(device)
    if rb is not None:
        for e, sub in enumerate(rb.buffer):
            dev_pos[e] = sub.pos
            dev_valid[e] = capacity if sub.full else sub.pos
    return rb_dev, dev_pos, dev_valid


def _event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on ``device``'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _done(event: Optional[torch.cuda.Event]) -> bool:
    return event is None or event.query()


class HostCopies:
    """Small tensors (a burst's mean losses) on their way from the trainer's
    stream to the host: :meth:`put` starts a non-blocking copy and records an
    event, :meth:`take` returns the ones that have landed, oldest first, so
    the env loop never waits on the card for them."""

    def __init__(self) -> None:
        self._q: "collections.deque" = collections.deque()

    def put(self, value: torch.Tensor, tag: Any = None) -> None:
        if value.is_cuda:
            self._q.append((value.to("cpu", non_blocking=True), _event(value.device), tag))
        else:
            self._q.append((value, None, tag))

    def take(self, wait: bool = False) -> List[Tuple[Any, List[float]]]:
        """``(tag, values)`` of every landed copy (of all, with ``wait``)."""
        out = []
        while self._q:
            host, event, tag = self._q[0]
            if not _done(event):
                if not wait:
                    break
                event.synchronize()
            self._q.popleft()
            out.append((tag, host.tolist()))
        return out


class HostSnapshot:
    """Packed snapshot of the player's parameters for the host-CPU player.

    ``card`` are the player's tensors on the trainer's device (parameters
    and buffers of the subset, the DreamerV3 harness's encoder, recurrent,
    representation and transition models, initial recurrent state and actor;
    SAC's actor), ``host`` their float32 CPU copies in the same order, which
    the host player's modules hold. Everything else (decoders, critics,
    optimizer state) never leaves the card."""

    def __init__(self, card: Sequence[torch.Tensor], host: Sequence[torch.Tensor],
                 wire_dtype: torch.dtype = torch.bfloat16) -> None:
        self.card = [t for t in card]
        self.host = [t for t in host]
        if [tuple(t.shape) for t in self.card] != [tuple(t.shape) for t in self.host]:
            raise ValueError("HostSnapshot: the card and host tensors differ in shape")
        self.wire_dtype = wire_dtype
        self.numel = int(sum(t.numel() for t in self.card))
        self.nbytes = self.numel * torch.empty((), dtype=wire_dtype).element_size()
        self._sizes = [t.numel() for t in self.card]
        # pinned landing buffers, made now: pinning memory later (cudaHostAlloc)
        # would wait for the card. At most one is being written (a refresh is
        # skipped while a copy is in flight), one waits in the slot and one is
        # being unpacked, so three always leave a free one.
        self._landing = ([torch.empty(self.numel, dtype=wire_dtype, pin_memory=True) for _ in range(3)]
                         if self.card[0].is_cuda else [])
        self._busy: List[bool] = [False] * len(self._landing)
        self._lock = threading.Lock()
        self._slot: Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event], int]] = None
        self._pending: Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event], int]] = None
        self._refresh_worker = None
        self.host_version = 0  # the version (the caller's count) the host copy holds
        self.pulls = 0  # device-to-host copies started
        self.polls = 0  # copies unpacked into the host modules

    # -- the three steps of a pull ------------------------------------------------
    @torch.no_grad()
    def pack(self) -> torch.Tensor:
        """The subset as ONE new ``(numel,)`` tensor in the wire dtype, on
        the card and the current stream."""
        return torch.cat([t.detach().reshape(-1).to(self.wire_dtype) for t in self.card])

    def _copy(self, packed: torch.Tensor, after: Optional[torch.cuda.Event],
              version: int) -> Tuple[torch.Tensor, Optional[torch.cuda.Event], int]:
        """Start the device-to-host copy of ``packed`` into pinned memory on
        the current stream (after ``after``, the pack's event); returns
        ``(host buffer, its copy's event, version)``."""
        if packed.device.type != "cuda":
            return packed, None, version  # pack() made it: nothing else holds it
        if after is not None:
            torch.cuda.current_stream(packed.device).wait_event(after)
        with self._lock:
            i = self._busy.index(False)
            self._busy[i] = True
        host = self._landing[i]
        host.copy_(packed, non_blocking=True)
        self.pulls += 1
        return host, _event(packed.device), version

    def _release(self, host: torch.Tensor) -> None:
        for i, buf in enumerate(self._landing):
            if buf is host:
                with self._lock:
                    self._busy[i] = False

    @torch.no_grad()
    def _unpack(self, host: torch.Tensor) -> None:
        values = host.to(torch.float32).split(self._sizes)
        torch._foreach_copy_(self.host, [v.view(t.shape) for v, t in zip(values, self.host)])

    # -- the API ------------------------------------------------------------------
    def pull(self, version: int = 0) -> torch.Tensor:
        """Blocking pack, copy and unpack (start of the run; the parity
        tests). Returns the wire-dtype host copy."""
        host, event, _ = self._copy(self.pack(), None, version)
        if event is not None:
            event.synchronize()
        self._unpack(host)
        self._release(host)
        self.host_version = int(version)
        self.polls += 1
        return host

    def refresh_async(self, version: int = 0) -> bool:
        """Pack now on the caller's (the trainer's) stream and start the
        copy without waiting for it: ``poll`` adopts it once it has landed.
        Skipped (returns False) while an earlier copy is still in flight;
        a landed copy nobody polled yet is replaced (newest wins). With
        :meth:`attach_supervisor` the copy rides the supervised refresh
        worker."""
        with self._lock:
            if self._pending is not None or (self._slot is not None and not _done(self._slot[1])):
                return False
        packed = self.pack()
        after = _event(packed.device)
        if self._refresh_worker is not None:
            with self._lock:
                self._pending = (packed, after, int(version))
            return True
        copied = self._copy(packed, after, int(version))
        with self._lock:
            dropped, self._slot = self._slot, copied
        if dropped is not None:  # a landed copy nobody polled: newest wins
            self._release(dropped[0])
        return True

    def attach_supervisor(self, supervisor, name: str = "snapshot-refresh") -> None:
        """Run the copies on ONE persistent supervised worker (crash-only,
        ``lease_s=None``): a copy that dies (``ThreadKilled`` chaos at
        ``burst.snapshot.refresh``) is retried by the restarted worker
        instead of leaving the host policy frozen."""
        if self._refresh_worker is None:
            self._refresh_worker = supervisor.spawn(name=name, target=self._refresh_loop, lease_s=None)

    def _refresh_loop(self, ctx) -> None:
        from sheeprl_tpu_torch.fault.inject import fault_point

        while not ctx.cancelled:
            with self._lock:
                pending = self._pending
            if pending is None:
                time.sleep(0.02)
                continue
            ctx.beat()
            fault_point("burst.snapshot.refresh")  # chaos: kill-thread mid-pull
            host, event, version = self._copy(*pending)
            if event is not None:
                event.synchronize()  # the worker owns the wait
            with self._lock:
                dropped, self._slot = self._slot, (host, event, version)
                # a crash before this point leaves the pending copy for the
                # restarted worker (newest wins: a later refresh may replace it)
                if self._pending is pending:
                    self._pending = None
            if dropped is not None:
                self._release(dropped[0])

    def poll(self) -> bool:
        """Main thread: unpack the newest landed copy into the host modules.
        Returns whether one was adopted."""
        with self._lock:
            slot = self._slot
            if slot is None or not _done(slot[1]):
                return False
            self._slot = None
        self._unpack(slot[0])
        self._release(slot[0])
        self.host_version = slot[2]
        self.polls += 1
        return True


class TrainStateCopy:
    """A copy of a train state on its device, taken before each burst so a
    burst that dies part way can be undone before it is retried: the
    parameters and buffers of ``modules``, the optimizers' state tensors and
    the ``generators``' states (the port's optimizers make their state when
    they are built, so its tensors keep their shapes). The copy is one
    multi-tensor copy into buffers kept between bursts."""

    def __init__(self, modules: Sequence[torch.nn.Module], optimizers: Sequence[Any] = (),
                 generators: Sequence[torch.Generator] = ()) -> None:
        self.modules, self.optimizers, self.generators = list(modules), list(optimizers), list(generators)
        self._copy: List[torch.Tensor] = []
        self._layout: List[Tuple[torch.Size, torch.dtype, torch.device]] = []
        self._gen_states: List[torch.Tensor] = []
        self.restores = 0

    def _tensors(self) -> List[torch.Tensor]:
        out = [t.detach() for m in self.modules for t in (*m.parameters(), *m.buffers())]
        return out + [t for opt in self.optimizers for t in opt.state_tensors()]

    @torch.no_grad()
    def snapshot(self) -> None:
        tensors = self._tensors()
        layout = [(t.shape, t.dtype, t.device) for t in tensors]
        if layout != self._layout:
            self._copy, self._layout = [torch.empty_like(t) for t in tensors], layout
        torch._foreach_copy_(self._copy, tensors)
        self._gen_states = [g.get_state() for g in self.generators]

    @torch.no_grad()
    def restore(self) -> None:
        tensors = self._tensors()
        if [(t.shape, t.dtype, t.device) for t in tensors] != self._layout:
            raise RuntimeError("TrainStateCopy.restore: the train state changed shape since its snapshot")
        torch._foreach_copy_(tensors, self._copy)
        for g, s in zip(self.generators, self._gen_states):
            g.set_state(s)
        self.restores += 1


class TrainerThread:
    """Bounded-queue supervised trainer worker: jobs go in, ``step_fn(carry,
    job) -> (carry, metrics)`` runs off the env loop (``metrics`` None for a
    job that trained nothing), and the newest carry is readable at any time.
    The queue bound (``maxsize``) is the back-pressure.

    The worker runs under a :class:`~sheeprl_tpu_torch.fault.supervisor.Supervisor`
    (``fault.supervisor``-shaped ``supervisor_cfg``) with crash-only
    supervision (``lease_s=None``: a burst's duration is unbounded). A crash,
    the chaos ``ThreadKilled`` at ``burst.trainer.step`` included, restarts
    the worker, which dispatches the in-flight job again; past the restart
    budget the next :meth:`submit` or :meth:`check` raises the supervision
    error instead of blocking the env loop on a dead consumer.

    A step updates modules and optimizers in place, so a retried job must
    start from the state its first try started from: with ``rollback`` (a
    :class:`TrainStateCopy`) the worker copies the state before each job and
    restores it before a retry of a job that had started; the
    ``burst.trainer.step`` fault point itself comes before the step touches
    anything. Each step runs under :attr:`train_lock`, which a checkpoint
    takes to read the state between two jobs."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], Tuple[Any, Any]],
        carry: Any,
        maxsize: int = 2,
        supervisor_cfg: Optional[Dict[str, Any]] = None,
        name: str = "burst-trainer",
        rollback: Optional[TrainStateCopy] = None,
        device: "torch.device | str" = "cpu",
    ) -> None:
        from sheeprl_tpu_torch.fault.supervisor import Supervisor

        self._step_fn = step_fn
        self._rollback = rollback
        self.device = torch.device(device)
        self._carry = carry
        self._lock = threading.Lock()
        self.train_lock = threading.RLock()
        self._q: "_queue.Queue" = _queue.Queue(maxsize=maxsize)
        self._inflight: list = [None, False]  # the job being (re)dispatched, and whether its step started
        self._done = threading.Event()
        self.busy = False  # a step is running (the main thread reads it to time its act steps)
        self.step_host_s: List[Tuple[float, bool]] = []  # each job's host seconds, and whether it trained
        self.supervisor = Supervisor.from_config(supervisor_cfg or {}, name=name)
        self.supervisor.spawn(name=name, target=self._worker, lease_s=None)

    @property
    def carry(self) -> Any:
        with self._lock:
            return self._carry

    def check(self) -> None:
        """One supervision pass: raises the supervision error once the
        ladder is exhausted."""
        self.supervisor.check()

    def submit(self, job: Any) -> None:
        """Enqueue a job; back-pressure keeps driving supervision, so a dead
        trainer escalates instead of deadlocking the env loop."""
        while True:
            self.check()
            try:
                self._q.put(job, timeout=0.2)
                return
            except _queue.Full:
                continue

    def _worker(self, ctx) -> None:
        from sheeprl_tpu_torch.fault.inject import fault_point

        while not ctx.cancelled:
            job = self._inflight[0]
            if job is None:
                try:
                    job = self._q.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if job is None:  # close() sentinel: drained, expected exit
                    ctx.retire()
                    self._done.set()
                    return
                self._inflight[:] = [job, False]
            ctx.beat()
            fault_point("burst.trainer.step")  # chaos: kill-thread before the step touches anything
            with self.train_lock:
                if self._rollback is not None:
                    if self._inflight[1]:
                        self._rollback.restore()  # a retry: undo the part the dead try applied
                    else:
                        self._rollback.snapshot()
                self._inflight[1] = True
                self.busy = True
                t0 = time.perf_counter()
                try:
                    carry, metrics = self._step_fn(self._carry, job)
                finally:
                    self.busy = False
                self.step_host_s.append((time.perf_counter() - t0, metrics is not None))
                with self._lock:
                    self._carry = carry
                self._inflight[:] = [None, False]

    def close(self) -> Any:
        """Drain the queue, stop the worker, wait for the card to finish what
        it was given and return the final carry."""
        while True:  # a dead consumer and a full queue must escalate, not block
            self.check()
            try:
                self._q.put(None, timeout=0.2)
                break
            except _queue.Full:
                continue
        while not self._done.wait(0.2):
            self.check()
        self.supervisor.join()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._carry


class _Slab(dict):
    """One pinned host slab of a flush blob: numpy views per segment, the
    event after the upload that read it, and whether a queued job holds it."""

    def __init__(self, layout: BlobLayout, pinned: bool) -> None:
        blob = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=pinned)
        raw = blob.numpy()
        super().__init__({
            name: raw[off: off + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
            for name, off, shape, dtype in layout.segments
        })
        self.blob = blob
        self.event: Optional[torch.cuda.Event] = None
        self.held = False


class BurstRunner:
    """Staging and dispatch of the burst step on the trainer thread.

    ``burst_fn(carry, rb, blob, generator) -> (carry, rb, metrics)`` is
    :func:`sheeprl_tpu_torch.data.ring.build_burst_train_step`'s function
    (DreamerV3's ``make_train_step(..., ring=spec)``); ``carry`` holds the
    functional part of the train state (DreamerV3: ``(moments, cum)``), the
    modules and optimizers are updated in place. The train draws come from
    ``generator``, the ring's, on the trainer thread only.

    Each flush packs the staged rows, their write masks, the host heads and
    the granted-step mask into one pinned slab (the bucket's layout). A slab
    is refilled only after the job that holds it has run and its upload's
    event has completed, so a queued job never reads bytes a later flush
    wrote; a new slab is made when none is free."""

    def __init__(
        self,
        burst_fn: Callable,
        carry: Any,
        rb_dev: Dict[str, torch.Tensor],
        ring_keys: Dict[str, Tuple[tuple, Any]],
        n_envs: int,
        capacity: int,
        grad_chunk: int,
        stage_max: int,
        seq_len: int,
        snapshot: Optional[HostSnapshot] = None,
        snapshot_every: int = 4,
        stage_buckets: Optional[Tuple[int, ...]] = None,
        supervisor_cfg: Optional[Dict[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
        rollback: Optional[TrainStateCopy] = None,
        device: "torch.device | str" = "cpu",
    ) -> None:
        self.device = torch.device(device)
        self._burst_fn = burst_fn
        self._ring_keys = {k: (tuple(int(s) for s in shape), np.dtype(dtype))
                           for k, (shape, dtype) in ring_keys.items()}
        self._n_envs = int(n_envs)
        self._capacity = int(capacity)
        self.grad_chunk = int(grad_chunk)
        self._stage_max = int(stage_max)
        self._seq_len = int(seq_len)
        self._snapshot = snapshot
        self._snapshot_every = max(1, int(snapshot_every))
        self._stage_buckets = list(effective_stage_buckets(stage_buckets, self._stage_max))
        self._layouts = make_blob_layouts(self._ring_keys, self._n_envs, self.grad_chunk, tuple(self._stage_buckets))
        # two slabs a bucket pinned now (pinning later would wait for the card); more are made when none is free
        self._slabs: Dict[int, List[_Slab]] = {
            b: [_Slab(self._layouts[b], self.device.type == "cuda") for _ in range(2)] for b in self._stage_buckets}
        self.generator = generator

        self.dev_pos = np.zeros(self._n_envs, np.int64)
        self.dev_valid = np.zeros(self._n_envs, np.int64)
        self._staged: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = []
        self.bursts = 0  # trained bursts; trainer-thread state
        self.flushes = 0
        self.bytes_staged = 0
        self._metrics = HostCopies()  # each trained burst's mean metrics, tagged with its count
        self._thread = TrainerThread(self._step, (carry, rb_dev), supervisor_cfg=supervisor_cfg,
                                     rollback=rollback, device=self.device)
        if snapshot is not None:
            # the refresh copies ride the trainer's supervisor
            snapshot.attach_supervisor(self._thread.supervisor)

    # -- ring-state restore (checkpoint resume) ------------------------------
    def set_ring_state(self, pos: np.ndarray, valid: np.ndarray) -> None:
        self.dev_pos[:] = pos
        self.dev_valid[:] = valid

    # -- staging -------------------------------------------------------------
    def stage(self, row: Dict[str, np.ndarray], env_mask: np.ndarray) -> None:
        self._staged.append((row, env_mask))

    def stage_step(self, step_data: Dict[str, np.ndarray]) -> None:
        """Stage a regular all-envs row from ``(1, n_envs, ...)`` step data."""
        self.stage({k: np.array(step_data[k][0]) for k in self._ring_keys}, np.ones(self._n_envs, np.int32))

    def stage_reset(self, reset_data: Dict[str, np.ndarray], env_idxes) -> None:
        """Stage a ragged reset row: only the done envs advance their heads
        (as ``EnvIndependentReplayBuffer.add(data, env_idxes)`` does)."""
        row = {}
        env_mask = np.zeros(self._n_envs, np.int32)
        env_mask[env_idxes] = 1
        for k, (shape, dtype) in self._ring_keys.items():
            full_row = np.zeros((self._n_envs,) + shape, dtype)
            full_row[env_idxes] = np.asarray(reset_data[k][0])
            row[k] = full_row
        self.stage(row, env_mask)

    def patch_last(self, env_idx: int, updates: Dict[str, float]) -> None:
        """In-place edit of the newest staged row for one env (the
        truncation patch of an env restart)."""
        if self._staged:
            for k, v in updates.items():
                self._staged[-1][0][k][env_idx] = v

    @property
    def staged_count(self) -> int:
        return len(self._staged)

    def staging_full(self) -> bool:
        return len(self._staged) >= self._stage_max - 1 - self._n_envs

    # -- trainer-thread handles ----------------------------------------------
    @property
    def trainer(self) -> TrainerThread:
        return self._thread

    @property
    def carry(self) -> Any:
        return self._thread.carry[0]

    def _step(self, carry_rb, job):
        carry, rb = carry_rb
        slab, trained = job
        carry, rb, metrics = self._burst_fn(carry, rb, slab.blob, self.generator)
        slab.event = _event(self.device)  # after the upload that read the slab
        slab.held = False
        if not trained or metrics is None:
            return (carry, rb), None  # an append-only burst has no metrics
        self.bursts += 1
        self._metrics.put(metrics, self.bursts)
        if self._snapshot is not None and self.bursts % self._snapshot_every == 0:
            self._snapshot.refresh_async(self.bursts)
        return (carry, rb), metrics

    def take_metrics(self, wait: bool = False) -> List[Tuple[int, List[float]]]:
        """The trained bursts' metrics whose copy to the host has landed (all
        of them with ``wait``), oldest first: ``(burst, values)``."""
        return self._metrics.take(wait)

    # -- dispatch ------------------------------------------------------------
    def _acquire(self, size: int) -> _Slab:
        for slab in self._slabs[size]:
            if not slab.held and _done(slab.event):
                break
        else:
            slab = _Slab(self._layouts[size], self.device.type == "cuda")
            self._slabs[size].append(slab)
        slab.held, slab.event = True, None
        return slab

    def flush(self, grant_backlog: int) -> int:
        """Pack the staged rows and up to ``grad_chunk`` grants into one
        burst job. Returns the grants consumed (0 while any env is still
        shorter than a sample window)."""
        n_rows = len(self._staged)
        size = next(b for b in self._stage_buckets if b >= n_rows)
        slab = self._acquire(size)
        for k in self._ring_keys:
            view = slab[k]
            for i, (row, _m) in enumerate(self._staged):
                view[i] = row[k]
            view[n_rows:] = 0
        mask = slab["__mask__"]
        mask[:] = 0
        for i, (_r, m) in enumerate(self._staged):
            mask[i] = m
        self._staged.clear()
        env_counts = mask.sum(axis=0).astype(np.int64)
        # hold grants while any env is still shorter than a sample window
        # (the host buffer refuses to sample in that state)
        ready = (self.dev_valid + env_counts).min() >= self._seq_len
        chunk = min(self.grad_chunk, grant_backlog) if ready else 0
        slab["__pos__"][:] = self.dev_pos
        slab["__valid_n__"][:] = self.dev_valid
        slab["__validmask__"][:] = 0.0
        slab["__validmask__"][:chunk] = 1.0
        self._thread.submit((slab, chunk > 0))
        self.dev_pos[:] = (self.dev_pos + env_counts) % self._capacity
        self.dev_valid[:] = np.minimum(self.dev_valid + env_counts, self._capacity)
        self.flushes += 1
        self.bytes_staged += int(slab.blob.numel())
        return chunk

    def close(self) -> Any:
        """Stop the trainer thread and return the final carry."""
        return self._thread.close()[0]


class HybridPlayerHarness:
    """The hybrid host-player burst path of a Dreamer main.

    Owns the ring (allocated on the card, or mirrored from a restored host
    buffer ``rb``), the :class:`HostSnapshot` of the player's subset, the
    :class:`BurstRunner`, the grant accounting and the per-flush metric
    fan-out; the main keeps the player, the carry and the checkpoint layout.
    ``make_burst_fn(ring_spec)`` returns the burst function for the spec;
    ``player_card``/``player_host`` are the player's tensors on the card and
    their CPU copies (the host player's modules), ``train_modules`` and
    ``optimizers`` the state a retried burst restores (:class:`TrainStateCopy`).

    The train draws come from the ring's generator, seeded with
    ``cfg.seed``; the host player's from a CPU generator seeded with
    ``cfg.seed + 17``: JAX's two streams, not its numbers."""

    def __init__(
        self,
        cfg: Any,
        *,
        ring_keys: Dict[str, Tuple[tuple, Any]],
        capacity: int,
        seq_len: int,
        batch_size: int,
        policy_steps_per_iter: int,
        make_burst_fn: Callable[[Dict[str, Any]], Callable],
        player_card: Sequence[torch.Tensor],
        player_host: Sequence[torch.Tensor],
        carry: Any,
        device: "torch.device | str",
        train_modules: Sequence[torch.nn.Module] = (),
        optimizers: Sequence[Any] = (),
        rb=None,
        metric_names: Sequence[str] = DREAMER_METRIC_NAMES,
        aggregator=None,
    ) -> None:
        hp_cfg = cfg.algo.get("hybrid_player") or {}
        train_every = max(1, int(hp_cfg.get("train_every", 16)))
        snapshot_every = max(1, int(hp_cfg.get("snapshot_every", 4)))
        n_envs = int(cfg.env.num_envs)
        self.device = torch.device(device)

        self.grad_chunk = max(1, int(round(float(cfg.algo.replay_ratio) * policy_steps_per_iter * train_every)))
        stage_max, stage_buckets = dreamer_stage_sizes(train_every, n_envs, capacity)
        buckets = effective_stage_buckets(stage_buckets, stage_max)
        ring_spec = {
            "capacity": int(capacity),
            "n_envs": n_envs,
            "grad_chunk": self.grad_chunk,
            "seq_len": int(seq_len),
            "batch_size": int(batch_size),
            "ring_keys": ring_keys,
            "stage_buckets": buckets,
            "stage_max": stage_max,
        }
        burst_fn = make_burst_fn(ring_spec)
        rb_dev, dev_pos, dev_valid = init_device_ring(ring_keys, capacity, n_envs, self.device, rb=rb)

        self.snapshot = HostSnapshot(player_card, player_host, torch.bfloat16)
        self.snapshot.pull()
        self.host_generator = torch.Generator().manual_seed(int(cfg.seed) + 17)
        self.generator = torch.Generator(device=self.device).manual_seed(int(cfg.seed))
        rollback = TrainStateCopy(train_modules, optimizers, [self.generator]) if train_modules else None
        self.runner = BurstRunner(
            burst_fn, carry, rb_dev, ring_keys,
            n_envs=n_envs, capacity=capacity, grad_chunk=self.grad_chunk, stage_max=stage_max, seq_len=seq_len,
            snapshot=self.snapshot, snapshot_every=snapshot_every, stage_buckets=stage_buckets,
            supervisor_cfg=(cfg.get("fault") or {}).get("supervisor"), generator=self.generator,
            rollback=rollback, device=self.device,
        )
        self.runner.set_ring_state(dev_pos, dev_valid)
        self._metric_names = tuple(metric_names)
        self._aggregator = aggregator
        self.metric_rows: List[List[float]] = []  # every trained burst's mean metrics, in order
        self.flush_host_s: List[float] = []

        self.grant_backlog = 0
        self.gradient_steps = 0  # cumulative gradient steps
        self.train_steps = 0  # flushes that trained

    # -- host player ---------------------------------------------------------
    def poll(self) -> bool:
        """Adopt the newest snapshot that has landed, if any."""
        return self.snapshot.poll()

    @property
    def snapshot_age(self) -> int:
        """Trained bursts since the host copy's version."""
        return self.runner.bursts - self.snapshot.host_version

    # -- staging (delegates) -------------------------------------------------
    def stage_step(self, step_data) -> None:
        self.runner.stage_step(step_data)

    def stage_reset(self, reset_data, env_idxes) -> None:
        self.runner.stage_reset(reset_data, env_idxes)

    def patch_last(self, env_idx: int, updates: Dict[str, float]) -> None:
        self.runner.patch_last(env_idx, updates)

    @property
    def carry(self) -> Any:
        return self.runner.carry

    @property
    def trainer(self) -> TrainerThread:
        return self.runner.trainer

    # -- grant accounting + dispatch -----------------------------------------
    def grant(self, n: int) -> None:
        self.grant_backlog += int(n)

    def _take_metrics(self, wait: bool = False) -> None:
        for _burst, row in self.runner.take_metrics(wait):
            self.metric_rows.append(row)
            agg = self._aggregator
            if agg is not None and not agg.disabled:
                for name, value in zip(self._metric_names, row):
                    if name in agg:
                        agg.update(name, value)

    def flush(self) -> int:
        from sheeprl_tpu_torch.utils.metric import SumMetric
        from sheeprl_tpu_torch.utils.timer import timer

        t0 = time.perf_counter()
        with timer("Time/train_time", SumMetric):
            chunk = self.runner.flush(self.grant_backlog)
            self._take_metrics()
        self.flush_host_s.append(time.perf_counter() - t0)
        self.grant_backlog -= chunk
        if chunk > 0:
            self.gradient_steps += chunk
            self.train_steps += 1
        return chunk

    def pump(self) -> None:
        """Dispatch while a full grant chunk (or a full staging buffer) is
        pending: the per-iteration train section of a burst main."""
        while self.grant_backlog >= self.grad_chunk or self.runner.staging_full():
            consumed = self.flush()
            if consumed == 0 or self.grant_backlog < self.grad_chunk:
                break

    def finish(self) -> Any:
        """Flush the tail (grants that can never run are abandoned with the
        run), stop the trainer thread and return the final carry."""
        while self.runner.staged_count or self.grant_backlog:
            if self.flush() == 0 and not self.runner.staged_count:
                break
        carry = self.runner.close()
        self._take_metrics(wait=True)
        return carry
