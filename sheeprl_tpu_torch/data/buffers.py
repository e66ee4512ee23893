"""Host replay buffers (counterpart of ``sheeprl_tpu/data/buffers.py``,
the parts PPO's rollout, SAC's host replay, the Dreamers' coupled loops and
Dreamer V2's whole-episode store use),
in numpy memory or, with ``memmap=True``, in files: one
:class:`~sheeprl_tpu_torch.data.memmap.MemmapArray` per key at
``<memmap_dir>/<key>.memmap`` (``<memmap_dir>/env_<i>/<key>.memmap`` for the
per-env buffers), as the JAX package lays them out. Sampling draws from a
numpy ``Generator`` in the same order as the JAX package's buffers, so one
seed gives the same windows, memmapped or not.

:class:`EpisodeBuffer` keeps whole episodes, memmapped one directory per
episode (``<memmap_dir>/episode_<uuid>/<key>.memmap``).

A buffer's ``state_dict`` holds its rows, memmapped or not: a resumed run
writes them into files under its own ``memmap_dir``. (The JAX package
pickles a memmapped buffer as views that name the old run's files.)"""

from __future__ import annotations

import uuid
from itertools import compress
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from sheeprl_tpu_torch.data.memmap import MEMMAP_MODES, MemmapArray

__all__ = ["ReplayBuffer", "SequentialReplayBuffer", "EnvIndependentReplayBuffer", "EpisodeBuffer"]


def _check_memmap(memmap: bool, memmap_dir: "str | Path | None", memmap_mode: str) -> Optional[Path]:
    if not memmap:
        return None
    if memmap_mode not in MEMMAP_MODES:
        raise ValueError(f"Accepted values for memmap_mode are {MEMMAP_MODES}, got '{memmap_mode}'")
    if memmap_dir is None:
        raise ValueError("memmap=True requires a 'memmap_dir'")
    return Path(memmap_dir)


def _host(v: "np.ndarray | MemmapArray") -> np.ndarray:
    return v.array if isinstance(v, MemmapArray) else v


class ReplayBuffer:
    """Ring buffer of ``(buffer_size, n_envs, ...)`` arrays, one per key,
    allocated by the first :meth:`add` (PPO's rollout storage, SAC's host
    replay); with ``memmap`` each key is a file in ``memmap_dir``, mapped
    with ``memmap_mode``."""

    def __init__(self, buffer_size: int, n_envs: int = 1, obs_keys: Sequence[str] = ("observations",),
                 memmap: bool = False, memmap_dir: "str | Path | None" = None, memmap_mode: str = "r+") -> None:
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be a positive integer (got {buffer_size})")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be a positive integer (got {n_envs})")
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._obs_keys = tuple(obs_keys)
        self._memmap_dir = _check_memmap(memmap, memmap_dir, memmap_mode)
        self._memmap_mode = memmap_mode
        if self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: Dict[str, Union[np.ndarray, MemmapArray]] = {}
        self._pos = 0
        self._full = False
        self._rng: np.random.Generator = np.random.default_rng()

    def __len__(self) -> int:
        return self._buffer_size

    @property
    def buffer(self) -> Dict[str, Union[np.ndarray, MemmapArray]]:
        """The storage, key by key (empty before the first :meth:`add`);
        install a key with :meth:`set_key`."""
        return self._buf

    @property
    def is_memmap(self) -> bool:
        return self._memmap_dir is not None

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def pos(self) -> int:
        return self._pos

    @property
    def full(self) -> bool:
        return self._full

    @property
    def empty(self) -> bool:
        return not self._buf or (self._pos == 0 and not self._full)

    def set_head(self, pos: int, full: bool) -> None:
        """Place the write head, for storage filled from elsewhere (a
        checkpointed device ring)."""
        self._pos, self._full = int(pos), bool(full)

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def _allocate(self, key: str, shape: tuple, dtype) -> Union[np.ndarray, MemmapArray]:
        if self._memmap_dir is None:
            return np.empty(shape, dtype=dtype)
        return MemmapArray(dtype, shape, filename=self._memmap_dir / f"{key}.memmap", mode=self._memmap_mode)

    def set_key(self, key: str, array: np.ndarray) -> None:
        """Install ``array`` (``(buffer_size, n_envs, ...)``) as the storage
        of ``key``: copied into the key's file when the buffer is
        memmapped, else kept as it is."""
        array = np.asarray(array)
        if tuple(array.shape[:2]) != (self._buffer_size, self._n_envs):
            raise ValueError(f"'{key}' of shape {array.shape} is not ({self._buffer_size}, {self._n_envs}, ...)")
        if self._memmap_dir is None:
            self._buf[key] = array
        else:
            self._buf.pop(key, None)  # the old owner deletes its file before the new one is made
            self._buf[key] = self._allocate(key, array.shape, array.dtype)
            self._buf[key][:] = array

    def _validate_add(self, data: Any) -> None:
        """``buffer.validate_args``'s checks, with the JAX buffer's errors:
        a dict of numpy arrays, each ``[sequence_length, n_envs, ...]``,
        congruent in those two dims."""
        if not isinstance(data, dict):
            raise ValueError(f"'data' must be a dictionary of numpy arrays, got '{type(data)}'")
        shapes = {}
        for k, v in data.items():
            if not isinstance(v, np.ndarray):
                raise ValueError(f"'data' must contain numpy arrays; key '{k}' has type '{type(v)}'")
            if v.ndim < 2:
                raise RuntimeError(
                    f"'data' must have at least 2 dimensions: [sequence_length, n_envs, ...]. Shape of '{k}' is {v.shape}"
                )
            shapes[k] = v.shape[:2]
        if len(set(shapes.values())) > 1:
            raise RuntimeError(f"Every array in 'data' must be congruent in the first 2 dimensions: {shapes}")

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Write ``(seq_len, n_envs, ...)`` rows at the head, wrapping around;
        ``validate_args`` (``buffer.validate_args``) checks ``data`` first."""
        if validate_args:
            self._validate_add(data)
        data_len = next(iter(data.values())).shape[0]
        next_pos = (self._pos + data_len) % self._buffer_size
        if next_pos <= self._pos or (data_len > self._buffer_size and not self._full):
            idxes = np.array(list(range(self._pos, self._buffer_size)) + list(range(0, next_pos)))
        else:
            idxes = np.arange(self._pos, next_pos)
        if data_len > self._buffer_size:
            data = {k: v[-self._buffer_size - next_pos :] for k, v in data.items()}
        if not self._buf:
            for k, v in data.items():
                self._buf[k] = self._allocate(k, (self._buffer_size, self._n_envs, *v.shape[2:]), v.dtype)
        for k, v in data.items():
            self._buf[k][idxes] = v
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = next_pos

    def state_dict(self) -> Dict[str, Any]:
        """The storage, the head and the generator state
        (``bit_generator.state``), as a checkpoint stores them (tensors and
        plain values), so a restored buffer draws what this one would draw
        next. The storage is allocated at the full ``buffer_size`` by the
        first :meth:`add`: until the buffer wraps, only the filled rows
        ``[0, pos)`` are saved (copied, so the file does not hold the whole
        allocation), and :meth:`load_state_dict` allocates the full size
        again. The restored buffer equals this one. A memmapped buffer's
        state holds its rows too (a full one's as a view of its file)."""
        buf = {k: torch.from_numpy(np.asarray(_host(v)) if self._full else _host(v)[: self._pos].copy())
               for k, v in self._buf.items()}
        return {"buffer": buf, "pos": self._pos, "full": self._full, "rng": self._rng.bit_generator.state}

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """:meth:`state_dict` with the JAX package's truncation patch
        (``CheckpointCallback._ckpt_rb``): the newest row's ``truncated`` is 1
        in every env, so a resumed run's next row never continues the saved
        episode. The patch is made on a copy of that key: the live buffer,
        memmapped or not, stays as it is while a save (asynchronous too)
        reads the state."""
        state = self.state_dict()
        if "truncated" in state["buffer"] and not self.empty:
            truncated = state["buffer"]["truncated"].clone()
            truncated[(self._pos - 1) % self._buffer_size] = 1
            state["buffer"]["truncated"] = truncated
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._buf = {}  # old owners delete their files before the new ones are made
        buf = {}
        for k, v in state["buffer"].items():
            rows = v.numpy()
            filled = len(self) if state["full"] else int(state["pos"])
            if rows.ndim < 2 or rows.shape[0] != filled or rows.shape[1] != self._n_envs:
                raise ValueError(
                    f"saved '{k}' of shape {tuple(rows.shape)} is not {filled} filled rows of a "
                    f"({len(self)}, {self._n_envs}, ...) buffer"
                )
            buf[k] = self._allocate(k, (len(self),) + rows.shape[1:], rows.dtype)
            buf[k][:filled] = rows
            buf[k][filled:] = 0
        self._buf = buf
        self.set_head(state["pos"], state["full"])
        self._rng.bit_generator.state = state["rng"]

    def sample(self, batch_size: int, n_samples: int = 1, sample_next_obs: bool = False) -> Dict[str, np.ndarray]:
        """Uniform ``(n_samples, batch_size, ...)`` transitions over the
        stored ``(row, env)`` grid, drawn as the JAX package's buffer draws
        them (rows, then envs, from one numpy generator).

        With ``sample_next_obs`` no next observation is stored: each key of
        ``obs_keys`` also comes back as ``next_<key>``, read from row ``(row
        + 1) % buffer_size`` of the same env, so a pair may cross an episode
        end, as the JAX buffer's does. The newest row has no successor yet
        and is not drawn (on a full buffer, the row just before the write
        head); fewer than two stored rows raise."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"need positive batch_size and n_samples (got {batch_size}, {n_samples})")
        if self.empty:
            raise ValueError("empty buffer: add() at least one transition before sampling")
        size = batch_size * n_samples
        if self._full:
            young_stop = self._pos - 1 if sample_next_obs else self._pos
            old_stop = len(self) if young_stop >= 0 else len(self) + young_stop
            eligible = np.array(list(range(0, young_stop)) + list(range(self._pos, old_stop)), dtype=np.intp)
            rows = eligible[self._rng.integers(0, len(eligible), size=(size,), dtype=np.intp)]
        else:
            newest_allowed = self._pos - 1 if sample_next_obs else self._pos
            if newest_allowed == 0:
                raise RuntimeError(
                    "sample_next_obs needs at least two stored transitions (the shifted-index pairing has nothing "
                    "to pair with yet)"
                )
            rows = self._rng.integers(0, newest_allowed, size=(size,), dtype=np.intp)
        envs = self._rng.integers(0, self._n_envs, size=(len(rows),), dtype=np.intp)
        flat = rows * self._n_envs + envs
        next_flat = ((rows + 1) % len(self)) * self._n_envs + envs
        out = {}
        for k, v in self._buf.items():
            v = np.asarray(_host(v))
            v = v.reshape(-1, *v.shape[2:])
            out[k] = np.take(v, flat, axis=0).reshape(n_samples, batch_size, *v.shape[1:])
            if sample_next_obs and k in self._obs_keys:
                out[f"next_{k}"] = np.take(v, next_flat, axis=0).reshape(n_samples, batch_size, *v.shape[1:])
        return out

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The storage, key by key: views, except that float64 keys are
        copied down to float32, as the JAX package's buffer hands them out."""
        out = {}
        for k, v in self._buf.items():
            v = np.asarray(_host(v))
            out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
        return out


class SequentialReplayBuffer(ReplayBuffer):
    """Samples ``sequence_length``-step contiguous windows
    ``(n_samples, sequence_length, batch_size, ...)``."""

    def sample(self, batch_size: int, n_samples: int = 1, sequence_length: int = 1) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"need positive batch_size and n_samples (got {batch_size}, {n_samples})")
        if not self._full and self._pos == 0:
            raise ValueError("empty buffer: add() at least one transition before sampling")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"a {sequence_length}-step window needs at least that many stored rows (have {self._pos})")
        if self._full and sequence_length > len(self):
            raise ValueError(f"The sequence length ({sequence_length}) is greater than the buffer size ({len(self)})")
        if self._full:
            # windows never cross the write head
            young_stop = self._pos - sequence_length + 1
            old_stop = self._buffer_size if young_stop >= 0 else self._buffer_size + young_stop
            eligible = np.array(list(range(0, young_stop)) + list(range(self._pos, old_stop)), dtype=np.intp)
            start_idxes = eligible[self._rng.integers(0, len(eligible), size=(batch_dim,), dtype=np.intp)]
        else:
            start_idxes = self._rng.integers(0, self._pos - sequence_length + 1, size=(batch_dim,), dtype=np.intp)
        idxes = (start_idxes.reshape(-1, 1) + np.arange(sequence_length, dtype=np.intp).reshape(1, -1))
        idxes = np.ravel(idxes % self._buffer_size)
        if self._n_envs == 1:
            env_idxes = np.zeros_like(idxes)
        else:
            env_idxes = self._rng.integers(0, self._n_envs, size=(batch_dim,), dtype=np.intp)
            env_idxes = np.ravel(np.tile(env_idxes.reshape(-1, 1), (1, sequence_length)))
        flat_idxes = idxes * self._n_envs + env_idxes
        out = {}
        for k, v in self._buf.items():
            v = np.asarray(_host(v))
            taken = np.take(v.reshape(-1, *v.shape[2:]), flat_idxes, axis=0)
            out[k] = np.swapaxes(taken.reshape(n_samples, batch_size, sequence_length, *taken.shape[1:]), 1, 2)
        return out


class EnvIndependentReplayBuffer:
    """One :class:`SequentialReplayBuffer` per environment, so ragged per-env
    writes (the reset rows of the envs that just finished) stay aligned; with
    ``memmap`` env ``i``'s files are in ``<memmap_dir>/env_<i>``."""

    def __init__(self, buffer_size: int, n_envs: int = 1, obs_keys: Sequence[str] = ("observations",),
                 memmap: bool = False, memmap_dir: "str | Path | None" = None, memmap_mode: str = "r+") -> None:
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be a positive integer (got {buffer_size})")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be a positive integer (got {n_envs})")
        root = _check_memmap(memmap, memmap_dir, memmap_mode)
        self._buf = [
            SequentialReplayBuffer(buffer_size, 1, obs_keys, memmap=memmap,
                                   memmap_dir=root / f"env_{i}" if root is not None else None, memmap_mode=memmap_mode)
            for i in range(n_envs)
        ]
        self._n_envs = int(n_envs)
        self._buffer_size = int(buffer_size)
        self._rng: np.random.Generator = np.random.default_rng()

    @property
    def buffer(self) -> List[SequentialReplayBuffer]:
        """The per-env buffers."""
        return self._buf

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def is_memmap(self) -> bool:
        return self._buf[0].is_memmap

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None,
            validate_args: bool = False) -> None:
        """Each column of ``data`` into its env's buffer; ``validate_args``
        has each env's buffer check its column first."""
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(f"{len(indices)} indices for {next(iter(data.values())).shape[1]} env columns")
        for col, env_idx in enumerate(indices):
            self._buf[env_idx].add({k: v[:, col : col + 1] for k, v in data.items()}, validate_args=validate_args)

    def state_dict(self) -> Dict[str, Any]:
        """Every per-env buffer's :meth:`~ReplayBuffer.state_dict` (storage,
        head and generator state; only the filled rows until it wraps) and
        the generator state of this buffer, which splits each draw over the
        envs. The JAX package pickles the buffer with its generators, so its
        resumed run draws what the uninterrupted run would have drawn; this
        state does the same."""
        return {"envs": [b.state_dict() for b in self._buf], "rng": self._rng.bit_generator.state}

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """:meth:`state_dict` with each env's newest row marked ``truncated``
        on a copy (:meth:`ReplayBuffer.checkpoint_state_dict`)."""
        return {"envs": [b.checkpoint_state_dict() for b in self._buf], "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["envs"]) != self._n_envs:
            raise ValueError(f"saved state holds {len(state['envs'])} env buffers, this buffer {self._n_envs}")
        for b, sub in zip(self._buf, state["envs"]):
            b.load_state_dict(sub)
        self._rng.bit_generator.state = state["rng"]

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"need positive batch_size and n_samples (got {batch_size}, {n_samples})")
        per_env = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)))
        parts = [b.sample(batch_size=int(n), n_samples=n_samples, **kwargs) for b, n in zip(self._buf, per_env) if n > 0]
        return {k: np.concatenate([p[k] for p in parts], axis=2) for k in parts[0]}


def _tensors(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(_host(v))) for k, v in data.items()}


class EpisodeBuffer:
    """Whole episodes, each stored once it ends (a row with ``terminated``
    or ``truncated`` set), evicted oldest first by cumulative length: an
    episode that would overflow ``buffer_size`` drops the fewest oldest
    episodes that make room. Episodes shorter than
    ``minimum_episode_length`` raise, as do longer ones than the buffer.
    :meth:`sample` draws ``sequence_length``-step windows that never cross
    an episode, laid out ``(n_samples, sequence_length, batch_size, ...)``;
    with ``prioritize_ends`` a window's start is drawn from ``sequence_length``
    more slots and clipped to the last one, so windows that end an episode
    come more often. Draws come from one numpy generator in the JAX
    package's order (the episodes, their counts, then each episode's
    starts), so a seed gives the JAX buffer's windows."""

    def __init__(
        self,
        buffer_size: int,
        minimum_episode_length: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: "str | Path | None" = None,
        memmap_mode: str = "r+",
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be a positive integer (got {buffer_size})")
        if minimum_episode_length <= 0:
            raise ValueError(f"minimum_episode_length must be positive (got {minimum_episode_length})")
        if buffer_size < minimum_episode_length:
            raise ValueError(f"The sequence length must be lower than the buffer size, got: bs = {buffer_size} and "
                             f"sl = {minimum_episode_length}")
        self._n_envs = int(n_envs)
        self._obs_keys = tuple(obs_keys)
        self._buffer_size = int(buffer_size)
        self._minimum_episode_length = int(minimum_episode_length)
        self._prioritize_ends = bool(prioritize_ends)
        self._memmap_dir = _check_memmap(memmap, memmap_dir, memmap_mode)
        self._memmap_mode = memmap_mode
        if self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(self._n_envs)]
        self._cum_lengths: List[int] = []
        self._buf: List[Dict[str, Union[np.ndarray, MemmapArray]]] = []
        self._rng: np.random.Generator = np.random.default_rng()

    @property
    def buffer(self) -> List[Dict[str, Union[np.ndarray, MemmapArray]]]:
        """The stored episodes, oldest first."""
        return self._buf

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def prioritize_ends(self) -> bool:
        return self._prioritize_ends

    @property
    def is_memmap(self) -> bool:
        return self._memmap_dir is not None

    @property
    def full(self) -> bool:
        return bool(self._buf) and self._cum_lengths[-1] + self._minimum_episode_length > self._buffer_size

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._buf else 0

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None,
            validate_args: bool = False) -> None:
        """Append ``(seq_len, len(env_idxes), ...)`` rows to each env's open
        episode; every row that ends an episode stores it.
        ``validate_args`` (``buffer.validate_args``) checks ``data`` and
        ``env_idxes`` first, with the JAX buffer's errors."""
        if validate_args:
            if not isinstance(data, dict) or not all(isinstance(v, np.ndarray) for v in data.values()):
                raise ValueError("'data' must be a dictionary of numpy arrays")
            if any(v.ndim < 2 for v in data.values()):
                raise RuntimeError("'data' must have at least 2 dims: [sequence_length, n_envs, ...]")
            if len({v.shape[:2] for v in data.values()}) > 1:
                raise RuntimeError("Every array in 'data' must be congruent in the first 2 dimensions")
            if "terminated" not in data or "truncated" not in data:
                raise RuntimeError(f"The episode must contain the 'terminated' and 'truncated' keys, got: {data.keys()}")
            if env_idxes is not None and (np.array(env_idxes) >= self._n_envs).any():
                raise ValueError(f"The env indices must be in [0, {self._n_envs}), given {env_idxes}")
        if "terminated" not in data or "truncated" not in data:
            raise RuntimeError(f"The episode must contain the 'terminated' and 'truncated' keys, got: {data.keys()}")
        if env_idxes is None:
            env_idxes = range(self._n_envs)
        for i, env in enumerate(env_idxes):
            env_data = {k: v[:, i] for k, v in data.items()}
            done = np.logical_or(env_data["terminated"], env_data["truncated"])
            episode_ends = done.nonzero()[0].tolist()
            if not episode_ends:
                self._open_episodes[env].append(env_data)
                continue
            episode_ends.append(len(done))
            start = 0
            for stop in episode_ends:
                episode = {k: v[start : stop + 1] for k, v in env_data.items()}
                if len(episode["terminated"]) > 0:
                    self._open_episodes[env].append(episode)
                start = stop + 1
                last = self._open_episodes[env][-1] if self._open_episodes[env] else None
                if last is not None and np.logical_or(last["terminated"][-1], last["truncated"][-1]):
                    self._save_episode(self._open_episodes[env])
                    self._open_episodes[env] = []

    def _store(self, episode: Dict[str, np.ndarray]) -> Dict[str, Union[np.ndarray, MemmapArray]]:
        if self._memmap_dir is None:
            return episode
        episode_dir = self._memmap_dir / f"episode_{uuid.uuid4()}"
        stored = {}
        for k, v in episode.items():
            stored[k] = MemmapArray(v.dtype, v.shape, filename=episode_dir / f"{k}.memmap", mode=self._memmap_mode)
            stored[k][:] = v
        return stored

    def _save_episode(self, chunks: Sequence[Dict[str, np.ndarray]]) -> None:
        if not chunks:
            raise RuntimeError("Invalid episode, an empty sequence is given.")
        episode = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
        ends = np.logical_or(episode["terminated"], episode["truncated"])
        ep_len = ends.shape[0]
        if len(ends.nonzero()[0]) != 1 or not ends[-1]:
            raise RuntimeError("The episode must contain exactly one done at the end")
        if ep_len < self._minimum_episode_length:
            raise RuntimeError(f"episode of {ep_len} steps is shorter than the minimum episode length "
                               f"{self._minimum_episode_length}")
        if ep_len > self._buffer_size:
            raise RuntimeError(f"episode of {ep_len} steps exceeds the buffer capacity of {self._buffer_size}")
        if self.full or len(self) + ep_len > self._buffer_size:
            cum_lengths = np.array(self._cum_lengths)
            last_to_remove = int(((len(self) - cum_lengths + ep_len) <= self._buffer_size).argmax())
            self._buf = self._buf[last_to_remove + 1 :]  # a memmapped episode's files go with its last reference
            self._cum_lengths = (cum_lengths[last_to_remove + 1 :] - cum_lengths[last_to_remove]).tolist()
        self._cum_lengths.append(len(self) + ep_len)
        self._buf.append(self._store(episode))

    def sample(self, batch_size: int, sample_next_obs: bool = False, n_samples: int = 1,
               sequence_length: int = 1, **kwargs: Any) -> Dict[str, np.ndarray]:
        """``(n_samples, sequence_length, batch_size, ...)`` windows, each
        inside one stored episode at least ``sequence_length`` rows long
        (longer, with ``sample_next_obs``: each key of ``obs_keys`` then also
        comes back as ``next_<key>``, the window one row later)."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive (got {batch_size})")
        if n_samples <= 0:
            raise ValueError(f"n_samples must be positive (got {n_samples})")
        ep_lens = np.array(self._cum_lengths) - np.array([0] + self._cum_lengths[:-1])
        valid_mask = ep_lens > sequence_length if sample_next_obs else ep_lens >= sequence_length
        valid_episodes = list(compress(self._buf, valid_mask))
        if not valid_episodes:
            raise RuntimeError(f"no stored episode is at least {sequence_length} steps long — nothing to sample")
        chunk = np.arange(sequence_length, dtype=np.intp).reshape(1, -1)
        nsample_per_eps = np.bincount(self._rng.integers(0, len(valid_episodes), (batch_size * n_samples,)))
        keys = list(valid_episodes[0])
        per_key: Dict[str, list] = {k: [] for k in keys}
        if sample_next_obs:
            per_key.update({f"next_{k}": [] for k in self._obs_keys})
        for i, n in enumerate(nsample_per_eps.astype(np.intp)):
            if n == 0:
                continue
            ep = valid_episodes[i]
            ep_len = len(ep["terminated"]) - int(sample_next_obs)
            upper = ep_len - sequence_length + 1 + (sequence_length if self._prioritize_ends else 0)
            starts = np.minimum(self._rng.integers(0, upper, size=(n,)).reshape(-1, 1), ep_len - sequence_length,
                                dtype=np.intp)
            indices = starts + chunk
            for k in keys:
                arr = np.asarray(_host(ep[k]))
                per_key[k].append(np.take(arr, indices.flat, axis=0).reshape(n, sequence_length, *arr.shape[1:]))
                if sample_next_obs and k in self._obs_keys:
                    per_key[f"next_{k}"].append(arr[indices + 1])
        out = {}
        for k, v in per_key.items():
            if v:
                joined = np.concatenate(v, axis=0)
                out[k] = np.moveaxis(joined.reshape(n_samples, batch_size, sequence_length, *joined.shape[2:]), 2, 1)
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The stored episodes (their rows, memmapped or not), the cumulative
        lengths, each env's open episode chunks and the generator state."""
        return {
            "episodes": [_tensors(ep) for ep in self._buf],
            "cum_lengths": list(self._cum_lengths),
            "open": [[_tensors(chunk) for chunk in chunks] for chunks in self._open_episodes],
            "rng": self._rng.bit_generator.state,
        }

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """:meth:`state_dict` without the open episodes, as the JAX
        package's ``CheckpointCallback._ckpt_rb`` saves the buffer: a
        resumed run starts every env's episode afresh. The live buffer keeps
        them."""
        state = self.state_dict()
        state["open"] = [[] for _ in range(self._n_envs)]
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["open"]) != self._n_envs:
            raise ValueError(f"saved state holds {len(state['open'])} envs' open episodes, this buffer {self._n_envs}")
        self._buf = []  # old owners delete their files before the new ones are made
        self._buf = [self._store({k: v.numpy() for k, v in ep.items()}) for ep in state["episodes"]]
        self._cum_lengths = [int(c) for c in state["cum_lengths"]]
        self._open_episodes = [[{k: v.numpy() for k, v in chunk.items()} for chunk in chunks]
                               for chunks in state["open"]]
        self._rng.bit_generator.state = state["rng"]
