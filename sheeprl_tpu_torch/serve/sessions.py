"""Stateful session serving (counterpart of ``sheeprl_tpu/serve/sessions.py``).

- :class:`SessionCache`: ``session_id -> slab row``. One preallocated device
  tensor per state leaf with ``max_sessions + 1`` rows (the extra row is the
  padding donor), and host-side metadata per session: a last-used stamp for
  the TTL sweep and the LRU spill cap, a generation tag for versioned re-init
  after an incompatible swap, and the counters the health probe reports.

- :class:`SessionEngine`: steps the admitted sessions in bucket-padded
  batches. A dispatch gathers the sessions' slab rows by index, merges the
  policy's initial state into rows flagged fresh (new sessions, client
  resets, generation-stale rows and every padding row) with ``torch.where``,
  runs ``policy.step_fn`` and writes the advanced rows back into the slab in
  place. A bucket is just a padded batch size: PyTorch runs eagerly, and
  padding keeps the batch shapes, and so the chosen kernels, to a fixed few.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.serve.policy import StatefulServePolicy, actions_to_host

__all__ = ["SessionCache", "SessionEngine", "default_session_buckets"]


def default_session_buckets() -> Tuple[int, ...]:
    # session traffic is closed-loop (a user sends step t+1 only after it has
    # step t), so the ladder tops out lower than a stateless one would
    return (1, 8, 32)


class _Session:
    __slots__ = ("row", "last_used", "generation", "needs_init")

    def __init__(self, row: int, now: float, generation: int) -> None:
        self.row = row
        self.last_used = now
        self.generation = generation
        # sticky until a dispatch has really initialised the row
        # (mark_stepped): a failed dispatch must not leave a new session
        # reading another session's stale slab row as its own state
        self.needs_init = True


class SessionCache:
    """``session_id -> device slab row`` with TTL eviction, an LRU spill cap
    and generation-tagged versioned re-init.

    The scheduler's worker thread does all the mutation; the lock guards the
    metadata and counters against concurrent health-probe reads.
    """

    def __init__(
        self,
        state_spec: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
        device: torch.device,
        max_sessions: int = 1024,
        ttl_s: float = 300.0,
        sweep_every_s: float = 1.0,
    ) -> None:
        if max_sessions < 1:
            raise ValueError(f"session.max_sessions must be >= 1, got {max_sessions}")
        self.max_sessions = int(max_sessions)
        self.ttl_s = float(ttl_s)
        self.sweep_every_s = float(sweep_every_s)
        self.state_spec = dict(state_spec)
        self.device = torch.device(device)
        #: row ``max_sessions`` is the padding donor, never a session's
        self.donor_row = self.max_sessions
        self.slab = {
            k: torch.zeros((self.max_sessions + 1, *shape), dtype=dtype, device=self.device)
            for k, (shape, dtype) in self.state_spec.items()
        }
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._free: List[int] = list(range(self.max_sessions - 1, -1, -1))
        self.generation = 0
        self.opened = 0  # newly claimed rows (client resets count separately)
        self.evicted_lru = 0  # spill-cap evictions
        self.evicted_ttl = 0  # TTL sweep evictions
        self.resets = 0  # involuntary re-inits after an incompatible swap
        self.client_resets = 0  # reset=True requests on a live session
        self.peak = 0
        self._last_sweep = time.monotonic()

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._sessions)

    @property
    def state_bytes(self) -> int:
        """Device bytes of the slab, donor row included."""
        return sum(t.numel() * t.element_size() for t in self.slab.values())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "live": len(self._sessions),
                "peak": self.peak,
                "max_sessions": self.max_sessions,
                "opened": self.opened,
                "evicted_lru": self.evicted_lru,
                "evicted_ttl": self.evicted_ttl,
                "resets": self.resets,
                "client_resets": self.client_resets,
                "generation": self.generation,
                "ttl_s": self.ttl_s,
                "state_bytes": self.state_bytes,
            }

    def touch(
        self, session_id: str, reset: bool = False, now: Optional[float] = None, protect: Any = ()
    ) -> Tuple[int, bool]:
        """Resolve ``session_id`` to its slab row for the batch being
        assembled; returns ``(row, fresh)``. A new session claims a free row,
        evicting the least recently used session outside ``protect`` when
        the cache is full; a live session of an older generation re-inits
        (counted as a reset); ``reset=True`` re-inits on request. The batch
        passes its own ids as ``protect``, or one admission round could evict
        a session it has just touched and give its row to two sessions."""
        now = time.monotonic() if now is None else now
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is not None:
                sess.last_used = now
                if sess.generation != self.generation:
                    sess.generation = self.generation
                    sess.needs_init = True
                    self.resets += 1
                if reset:
                    self.client_resets += 1
                    sess.needs_init = True
                return sess.row, sess.needs_init
            if not self._free:
                self._evict_lru_locked(protect)
            row = self._free.pop()
            self._sessions[session_id] = _Session(row, now, self.generation)
            self.opened += 1
            self.peak = max(self.peak, len(self._sessions))
            return row, True

    def _evict_lru_locked(self, protect) -> None:
        candidates = [k for k in self._sessions if k not in protect]
        if not candidates:
            raise RuntimeError(
                f"one batch holds more distinct live sessions than session.max_sessions="
                f"{self.max_sessions} can cache: raise max_sessions (or lower max_batch)"
            )
        victim = min(candidates, key=lambda k: self._sessions[k].last_used)
        self._free.append(self._sessions.pop(victim).row)
        self.evicted_lru += 1

    def mark_stepped(self, session_ids) -> None:
        """A dispatch has initialised or advanced these sessions' rows."""
        with self._lock:
            for sid in session_ids:
                sess = self._sessions.get(sid)
                if sess is not None:
                    sess.needs_init = False

    def sweep(self, now: Optional[float] = None) -> int:
        """Evict every session idle longer than ``ttl_s``; returns how many."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._last_sweep = now
            stale = [sid for sid, s in self._sessions.items() if now - s.last_used > self.ttl_s]
            for sid in stale:
                self._free.append(self._sessions.pop(sid).row)
            self.evicted_ttl += len(stale)
            return len(stale)

    def maybe_sweep(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        if now - self._last_sweep < self.sweep_every_s:
            return 0
        return self.sweep(now)

    def invalidate_all(self) -> None:
        """After an incompatible swap: every live session re-inits (and
        counts a reset) on its next touch; ids, rows and LRU order stay."""
        with self._lock:
            self.generation += 1


class SessionEngine:
    """Bucket-padded batched session stepping on ``policy.device``.

    ``mode`` is ``"greedy"`` or ``"sample"``: a session server runs one
    action mode, since mixing them would tear a session's stream.
    """

    def __init__(
        self,
        policy: StatefulServePolicy,
        buckets: Optional[Sequence[int]] = None,
        mode: str = "greedy",
        max_sessions: int = 1024,
        ttl_s: float = 300.0,
        sweep_every_s: float = 1.0,
    ) -> None:
        buckets = tuple(sorted({int(b) for b in (buckets or default_session_buckets())}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"session bucket ladder must be positive ints, got {buckets}")
        if mode not in ("greedy", "sample"):
            raise ValueError(f"session engine mode must be greedy|sample, got {mode!r}")
        self.policy = policy
        self.device = torch.device(policy.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.buckets = buckets
        self.mode = mode
        self.greedy = mode == "greedy"
        self.cache = SessionCache(
            policy.state_spec(), self.device, max_sessions=max_sessions, ttl_s=ttl_s, sweep_every_s=sweep_every_s
        )
        self._lock = threading.Lock()
        self.dispatches = 0
        self.warmup_dispatches = 0
        self.rows = 0
        self.padded_rows = 0
        self._warmup()

    def _warmup(self) -> None:
        """Step every bucket once on donor rows, so the first request of a
        bucket does not pay for library handles and kernel selection. Donor
        rows re-init on every dispatch, so nothing stays behind."""
        for b in self.buckets:
            obs = {k: np.zeros((b, *shape), np.dtype(dtype)) for k, (shape, dtype) in self.policy.obs_spec.items()}
            idx = np.full((b,), self.cache.donor_row, np.int64)
            self._dispatch(self.policy.params, idx, np.ones((b,), np.bool_), obs, b)
            self.warmup_dispatches += 1

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dispatch(self, params: Any, idx: np.ndarray, fresh: np.ndarray, obs: Dict[str, np.ndarray], n: int) -> np.ndarray:
        dev = self.device
        slab = self.cache.slab
        with torch.no_grad():
            idx_t = torch.from_numpy(idx).to(dev)
            fresh_t = torch.from_numpy(fresh).to(dev)
            obs_t = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            gathered = {k: s.index_select(0, idx_t) for k, s in slab.items()}
            # init rows are identical, so one row broadcast over the batch
            init = self.policy.init_fn(params, 1)
            state = {
                k: torch.where(fresh_t.view(-1, *([1] * (g.ndim - 1))), init[k].to(g.dtype), g)
                for k, g in gathered.items()
            }
            actions, new_state = self.policy.step_fn(params, obs_t, state, self.greedy)
            new_rows = {k: new_state[k].to(slab[k].dtype) for k in slab}
            # In place: the JAX engine donated the slab to its step program;
            # here the rows are written back into the same device tensors.
            # Duplicate indices only ever name the donor row, whose content
            # is re-initialised on every dispatch.
            for k, s in slab.items():
                s.index_copy_(0, idx_t, new_rows[k])
            # the one host sync of a step: the caller needs the actions
            return actions_to_host(actions[:n])

    def check_swap(self, params: Any) -> bool:
        """Do swapped params keep the per-row state shapes and dtypes? If not,
        the cache's generation moves on and every session re-inits (counted
        as a reset) instead of feeding the step rows it cannot read. Returns
        True iff the sessions survive."""
        try:
            compatible = self.policy.state_spec(params) == self.cache.state_spec
        except Exception:  # init_fn cannot even run under the new params
            compatible = False
        if not compatible:
            self.cache.invalidate_all()
        return compatible

    def step_sessions(
        self,
        params: Any,
        obs: Dict[str, np.ndarray],
        session_ids: Sequence[Optional[str]],
        resets: Optional[Sequence[bool]] = None,
    ) -> np.ndarray:
        """Resolve each row's session (``None``: a one-shot step from a fresh
        state on the donor row), dispatch, and only after a successful
        dispatch clear the sessions' fresh flags. A session id appears at
        most once per call."""
        resets = [False] * len(session_ids) if resets is None else list(resets)
        now = time.monotonic()
        batch_ids = {sid for sid in session_ids if sid is not None}
        rows: List[int] = []
        fresh: List[bool] = []
        for sid, rs in zip(session_ids, resets):
            if sid is None:
                rows.append(self.cache.donor_row)
                fresh.append(True)
            else:
                row, fr = self.cache.touch(sid, reset=rs, now=now, protect=batch_ids)
                rows.append(row)
                fresh.append(fr)
        actions = self.infer_sessions(params, obs, rows, fresh)
        self.cache.mark_stepped([sid for sid in session_ids if sid is not None])
        return actions

    def infer_sessions(
        self, params: Any, obs: Dict[str, np.ndarray], rows: Sequence[int], fresh: Sequence[bool]
    ) -> np.ndarray:
        """Step ``n`` admitted rows against one params snapshot; returns the
        ``(n, action_dim)`` actions. Pads into the smallest bucket that holds
        ``n`` (padding steps the donor row, always fresh); a batch above the
        largest bucket goes through it in order, chunk by chunk."""
        n = self.policy.validate_batch(obs)
        if n != len(rows) or n != len(fresh):
            raise ValueError(f"{n} obs rows but {len(rows)} session rows / {len(fresh)} fresh flags")
        cap = self.buckets[-1]
        if n > cap:
            outs = [
                self.infer_sessions(
                    params, {k: v[start : start + cap] for k, v in obs.items()},
                    rows[start : start + cap], fresh[start : start + cap],
                )
                for start in range(0, n, cap)
            ]
            return np.concatenate(outs, axis=0)
        bucket = self.bucket_for(n)
        idx = np.full((bucket,), self.cache.donor_row, np.int64)
        idx[:n] = np.asarray(rows, np.int64)
        fresh_arr = np.ones((bucket,), np.bool_)
        fresh_arr[:n] = np.asarray(fresh, np.bool_)
        padded = {}
        for k, v in obs.items():
            buf = np.zeros((bucket, *v.shape[1:]), np.dtype(self.policy.obs_spec[k][1]))
            buf[:n] = v
            padded[k] = buf
        with self._lock:
            actions = self._dispatch(params, idx, fresh_arr, padded, n)
            self.dispatches += 1
            self.rows += n
            self.padded_rows += bucket - n
        return actions

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.rows + self.padded_rows
            return {
                "dispatches": self.dispatches,
                "warmup_dispatches": self.warmup_dispatches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_fill_ratio": round(self.rows / total, 4) if total else 0.0,
            }
