"""Stateless policy inference over a static bucket ladder (counterpart of
``sheeprl_tpu/serve/engine.py``).

:class:`BucketEngine` pads every batch to the smallest bucket of a fixed
ladder that holds it, so the device only ever sees a few batch shapes (and
so a few kernel choices), all warmed at construction. Each bucket owns one
preallocated staging slab: host memory (pinned when the device is a GPU) and
its device twin. A batch is copied row by row into the host slab, its tail
rows are zeroed, the slab goes to the device in one asynchronous copy per
observation key, and the real rows come back. Batches beyond the largest
bucket are chunked through it, in order.

Hot-swap contract: ``infer`` takes the weights per call and the engine holds
none, so a swapped-in params object serves the very next batch and every
batch runs under exactly one weights snapshot.

Sample mode takes a ``key``, ``(seed, batch_index)``: row ``r`` of the batch
draws its random numbers from ``counter_uniform`` with the batch index in the
seed's high 32 bits and ``r`` as its counter, so rows are decorrelated and a
row's draws do not depend on the bucket or chunk it lands in (a chunk is
offset by its start row, as the JAX engine's ``fold_in(key, start)``).

:class:`NaiveEngine` is the per-request baseline that ``serve.engine=naive``
selects: one eager dispatch per request at its own shape, no padding, no
slab.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.serve.policy import ServePolicy, actions_to_host

__all__ = ["BucketEngine", "NaiveEngine", "default_buckets", "chunk_plan", "check_chunk_order", "row_keys"]

_M32 = 0xFFFFFFFF


def default_buckets() -> Tuple[int, ...]:
    return (1, 8, 32, 128)


def chunk_plan(n: int, cap: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` spans chunking an ``n``-row batch through a
    ``cap``-row ladder top."""
    return [(start, min(start + cap, n)) for start in range(0, n, cap)]


def check_chunk_order(spans: List[Tuple[int, int]], n: int) -> None:
    """Raise unless a chunk plan walks ``[0, n)`` in order and contiguously:
    a reordered chunk would hand one caller another caller's rows."""
    expect = 0
    for start, stop in spans:
        if start != expect or stop <= start:
            raise RuntimeError(
                f"serve chunk plan out of order: spans {spans} do not walk [0, {n}) contiguously; "
                "rows would reach the wrong callers"
            )
        expect = stop
    if expect != n:
        raise RuntimeError(f"serve chunk plan covers [0, {expect}) but the batch has {n} rows")


def row_keys(key: Tuple[int, int], start: int, n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int64 ``(n,)`` seeds and counters of rows ``start .. start+n`` of
    a batch keyed ``(seed, batch_index)``."""
    seed, batch = key
    packed = (int(seed) & _M32) | ((int(batch) & 0x7FFFFFFF) << 32)
    seeds = torch.full((n,), packed, dtype=torch.int64, device=device)
    return seeds, torch.arange(start, start + n, dtype=torch.int64, device=device)


def _engine_device(policy: ServePolicy) -> torch.device:
    device = torch.device(policy.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_mode(mode: str) -> None:
    if mode not in ("greedy", "sample"):
        raise ValueError(f"engine mode must be greedy|sample, got {mode!r}")


def _resolve_greedy(mode: str, greedy: Optional[bool], key: Optional[Tuple[int, int]]) -> bool:
    if greedy is None:
        greedy = mode == "greedy"
    if greedy != (mode == "greedy"):
        raise ValueError(f"engine built for mode={mode!r} cannot serve {'greedy' if greedy else 'sample'} requests")
    if not greedy and key is None:
        raise ValueError("sample-mode infer needs a key (seed, batch_index)")
    return greedy


def _call(policy: ServePolicy, params: Any, obs: Dict[str, torch.Tensor], greedy: bool,
          key: Optional[Tuple[int, int]], start: int, rows: int, device: torch.device) -> torch.Tensor:
    if greedy:
        return policy.greedy_fn(params, obs)
    return policy.sample_fn(params, obs, policy.draw_fn(*row_keys(key, start, rows, device)))


class BucketEngine:
    """Bucket-padded stateless inference on ``policy.device``.

    ``mode`` is ``"greedy"`` or ``"sample"``, the mode the buckets are
    warmed in and the only one ``infer`` serves. :meth:`infer` reuses the
    per-bucket slabs under an internal lock, so direct multi-threaded use is
    safe; the scheduler drives it from one worker thread anyway.
    """

    def __init__(
        self,
        policy: ServePolicy,
        buckets: Optional[Sequence[int]] = None,
        mode: str = "greedy",
        warmup: bool = True,
    ) -> None:
        buckets = tuple(sorted({int(b) for b in (buckets or default_buckets())}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket ladder must be positive ints, got {buckets}")
        _check_mode(mode)
        self.policy = policy
        self.buckets = buckets
        self.mode = mode
        self.greedy = mode == "greedy"
        self.device = _engine_device(policy)
        pinned = self.device.type == "cuda"
        self._host: Dict[int, Dict[str, torch.Tensor]] = {}
        self._slab: Dict[int, Dict[str, torch.Tensor]] = {}
        for b in buckets:
            host = {}
            for k, (shape, dtype) in policy.obs_spec.items():
                t = torch.from_numpy(np.zeros((b, *shape), np.dtype(dtype)))
                host[k] = t.pin_memory() if pinned else t
            self._host[b] = host
            # on the CPU the host slab is the device slab
            self._slab[b] = {k: torch.empty_like(t, device=self.device) for k, t in host.items()} if pinned else host
        self._lock = threading.Lock()
        self.dispatches = 0
        self.rows = 0
        self.padded_rows = 0
        if warmup:
            self._warmup()

    def _warmup(self) -> None:
        """Run every bucket once on a zeroed slab, so the first request of a
        bucket does not pay for library handles and kernel selection. Not
        counted in the stats."""
        with torch.no_grad():
            for b in self.buckets:
                for t in self._slab[b].values():
                    t.zero_()
                out = _call(self.policy, self.policy.params, self._slab[b], self.greedy, (0, 0), 0, b, self.device)
                out.cpu()

    def bucket_for(self, n: int) -> int:
        """Smallest bucket admitting ``n`` rows (the largest if ``n`` exceeds
        the ladder: the caller chunks)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def infer(
        self,
        params: Any,
        obs: Dict[str, np.ndarray],
        greedy: Optional[bool] = None,
        key: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Env-format actions ``(n, action_dim)`` for a prepared batch of any
        ``n >= 1`` rows, as a host array. ``greedy`` defaults by the engine's
        mode; sample mode needs ``key``."""
        greedy = _resolve_greedy(self.mode, greedy, key)
        n = self.policy.validate_batch(obs)
        cap = self.buckets[-1]
        if n <= cap:
            return self._dispatch(params, obs, n, greedy, key, 0)
        spans = chunk_plan(n, cap)
        check_chunk_order(spans, n)
        return np.concatenate(
            [self._dispatch(params, {k: v[a:b] for k, v in obs.items()}, b - a, greedy, key, a) for a, b in spans],
            axis=0,
        )

    def _dispatch(self, params: Any, obs: Dict[str, np.ndarray], n: int, greedy: bool,
                  key: Optional[Tuple[int, int]], start: int) -> np.ndarray:
        bucket = self.bucket_for(n)
        with self._lock:
            host, slab = self._host[bucket], self._slab[bucket]
            for k, v in obs.items():
                dst = host[k].numpy()
                np.copyto(dst[:n], v)
                dst[n:] = 0  # the slab holds the last batch's rows: padding must be deterministic
            with torch.no_grad():
                if slab is not host:
                    for k, t in slab.items():
                        t.copy_(host[k], non_blocking=True)
                out = _call(self.policy, params, slab, greedy, key, start, bucket, self.device)
                # the copy back waits for the device, so the host slab is free
                # again once it returns
                actions = actions_to_host(out[:n])
            self.dispatches += 1
            self.rows += n
            self.padded_rows += bucket - n
        return actions

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.rows + self.padded_rows
            return {
                "dispatches": self.dispatches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_fill_ratio": round(self.rows / total, 4) if total else 0.0,
            }


class NaiveEngine:
    """One eager dispatch per request at its own shape: the baseline the
    bucket engine is measured against (counterpart of the JAX package's
    ``JitEngine``, which traces one program per new batch size; PyTorch
    runs eagerly and has no trace to cache, so only the per-request
    dispatch at an unpadded shape is left). Same ``infer`` surface as
    :class:`BucketEngine`."""

    def __init__(self, policy: ServePolicy, mode: str = "greedy") -> None:
        _check_mode(mode)
        self.policy = policy
        self.mode = mode
        self.greedy = mode == "greedy"
        self.buckets: Tuple[int, ...] = ()
        self.device = _engine_device(policy)
        self._lock = threading.Lock()
        self.dispatches = 0
        self.rows = 0

    def infer(
        self,
        params: Any,
        obs: Dict[str, np.ndarray],
        greedy: Optional[bool] = None,
        key: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        greedy = _resolve_greedy(self.mode, greedy, key)
        n = self.policy.validate_batch(obs)
        with torch.no_grad():
            obs_t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in obs.items()}
            actions = actions_to_host(_call(self.policy, params, obs_t, greedy, key, 0, n, self.device))
        with self._lock:
            self.dispatches += 1
            self.rows += n
        return actions

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "rows": self.rows,
                "padded_rows": 0,
                "batch_fill_ratio": 1.0 if self.rows else 0.0,
            }
