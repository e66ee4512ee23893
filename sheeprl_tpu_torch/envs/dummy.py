"""The deterministic fake envs (counterpart of ``sheeprl_tpu/envs/dummy.py``)
without gymnasium or OpenCV: their spaces are the plain specs of a run
config's ``spaces`` block.

- :class:`AtariProtocolDummyEnv`, the Atari-protocol stand-in; its area
  resize is :func:`resize_area`, which reproduces OpenCV's ``INTER_AREA``
  for uint8 images, and its gray frames :func:`rgb_to_gray`, OpenCV's
  ``COLOR_RGB2GRAY``.
- The step-counter envs of the JAX test suite, one per action-space kind
  (:class:`ContinuousDummyEnv`, :class:`DiscreteDummyEnv`,
  :class:`MultiDiscreteDummyEnv`): every observation value is the step
  counter (pixels mod 256), the reward 0, and an episode terminates on the
  step after ``n_steps``. Pixels come at ``screen_size`` directly: the JAX
  factory's area resize of a constant 64x64 frame is that constant."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "AtariProtocolDummyEnv",
    "ContinuousDummyEnv",
    "DiscreteDummyEnv",
    "MultiDiscreteDummyEnv",
    "COUNTER_ENVS",
    "resize_area",
    "rgb_to_gray",
]


def _area_table(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output index, the source indices and float32 weights OpenCV's
    ``computeResizeAreaTab`` gives it, in its order, padded with weight 0."""
    scale = 1.0 / (dst / src)
    rows: List[List[Tuple[int, float]]] = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row.extend((s, 1.0 / cell) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(row)
    width = max(len(r) for r in rows)
    idx = np.zeros((dst, width), dtype=np.intp)
    alpha = np.zeros((dst, width), dtype=np.float32)
    for d, row in enumerate(rows):
        for j, (s, a) in enumerate(row):
            idx[d, j], alpha[d, j] = s, np.float32(a)
    return idx, alpha


def resize_area(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Downscale an ``(H, W, C)`` uint8 image by area averaging, with
    OpenCV's ``INTER_AREA`` arithmetic for a non-integer scale: float32
    partial sums along each row in the table's order, then down the columns,
    rounded half to even."""
    xi, xa = _area_table(image.shape[1], width)
    yi, ya = _area_table(image.shape[0], height)
    rows = np.zeros((image.shape[0], width, image.shape[2]), dtype=np.float32)
    for j in range(xi.shape[1]):
        rows = rows + image[:, xi[:, j], :] * xa[None, :, j, None]
    out = np.zeros((height, width, image.shape[2]), dtype=np.float32)
    for j in range(yi.shape[1]):
        out = out + ya[:, j, None, None] * rows[yi[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


#: OpenCV's fixed-point gray weights of R, G and B for 8-bit images (0.299,
#: 0.587, 0.114 scaled by 2^15, summing to 2^15: ``color_rgb.simd.hpp``'s
#: ``RY15``, ``GY15``, ``BY15``)
_GRAY_WEIGHTS = (9798, 19235, 3735)
_GRAY_SHIFT = 15


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
    """An ``(H, W, 3)`` uint8 RGB image as ``(H, W, 1)`` uint8 gray, with
    OpenCV's ``COLOR_RGB2GRAY`` arithmetic for 8-bit images: the weighted sum
    in integers, rounded by adding half of ``2^15`` before the shift."""
    rgb = image.astype(np.int32)
    acc = sum(rgb[..., c] * w for c, w in enumerate(_GRAY_WEIGHTS))
    return ((acc + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)[..., None]


class _CounterEnv:
    """An env whose observations are the step counter broadcast into each
    key: ``rgb`` ``(screen_size, screen_size, 3)`` uint8 and ``state``
    ``vector_shape`` float32."""

    def __init__(self, actions: Dict[str, Any], n_steps: int, screen_size: int = 64,
                 vector_shape: Tuple[int, ...] = (10,)) -> None:
        self._actions = dict(actions)
        self._n_steps = int(n_steps)
        self._screen_size = int(screen_size)
        self._vector_shape = tuple(int(d) for d in vector_shape)
        self._t = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        s = self._screen_size
        return {
            "obs": {"rgb": {"shape": [s, s, 3], "dtype": "uint8"},
                    "state": {"shape": list(self._vector_shape), "dtype": "float32"}},
            "actions": dict(self._actions),
        }

    def _observe(self) -> Dict[str, np.ndarray]:
        s = self._screen_size
        return {"rgb": np.full((s, s, 3), self._t % 256, dtype=np.uint8),
                "state": np.full(self._vector_shape, self._t, dtype=np.float32)}

    def step(self, action):
        terminated = self._t == self._n_steps
        self._t += 1
        return self._observe(), 0.0, terminated, False, {}

    def reset(self, seed=None, options=None):
        self._t = 0
        return self._observe(), {}

    def close(self) -> None:
        pass


class ContinuousDummyEnv(_CounterEnv):
    def __init__(self, screen_size: int = 64, n_steps: int = 128, vector_shape: Tuple[int, ...] = (10,),
                 action_dim: int = 2) -> None:
        actions = {"shape": [int(action_dim)], "low": [-1.0] * int(action_dim), "high": [1.0] * int(action_dim),
                   "continuous": True}
        super().__init__(actions, n_steps, screen_size, vector_shape)


class DiscreteDummyEnv(_CounterEnv):
    def __init__(self, screen_size: int = 64, n_steps: int = 4, vector_shape: Tuple[int, ...] = (10,),
                 action_dim: int = 2) -> None:
        super().__init__({"n": [int(action_dim)], "continuous": False}, n_steps, screen_size, vector_shape)


class MultiDiscreteDummyEnv(_CounterEnv):
    def __init__(self, screen_size: int = 64, n_steps: int = 128, vector_shape: Tuple[int, ...] = (10,),
                 action_dims: Sequence[int] = (2, 2)) -> None:
        super().__init__({"n": [int(d) for d in action_dims], "continuous": False}, n_steps, screen_size, vector_shape)


#: env id -> counter env class, the ids the JAX factory's ``get_dummy_env`` reads
COUNTER_ENVS = {
    "continuous_dummy": ContinuousDummyEnv,
    "discrete_dummy": DiscreteDummyEnv,
    "multidiscrete_dummy": MultiDiscreteDummyEnv,
}


class AtariProtocolDummyEnv:
    """Deterministic ALE-protocol stand-in: 210x160x3 uint8 raw frames
    resized to ``screen_size``, 18 actions, deterministic noop starts,
    frame-skip with a 2-frame max-pool, a 3-lives game-over episode and a
    scripted action-coupled reward; with ``grayscale`` the resized frame
    becomes one gray channel. Everything is a pure function of ``(seed,
    action sequence)``; ``step``/``reset`` follow the gymnasium protocol."""

    RAW_SHAPE = (210, 160, 3)
    N_ACTIONS = 18

    def __init__(
        self,
        screen_size: int = 64,
        frame_skip: int = 4,
        grayscale: bool = False,
        noop_max: int = 30,
        lives: int = 3,
        life_len: int = 500,
        seed: int = 0,
    ):
        self.frame_skip = int(frame_skip)
        self._grayscale = bool(grayscale)
        self._screen_size = int(screen_size)
        self._noop_max = int(noop_max)
        self._start_lives = int(lives)
        self._life_len = int(life_len)
        self._seed = int(seed)
        h, w, _ = self.RAW_SHAPE
        y = np.arange(h, dtype=np.uint32)[:, None]
        x = np.arange(w, dtype=np.uint32)[None, :]
        base = np.stack([(y * 3 + x) % 251, (y + x * 5) % 241, (y * 7 ^ x) % 239], axis=-1)
        self._base = base.astype(np.uint8)
        self._t = 0
        self._lives = self._start_lives
        self._life_deadlines: List[int] = []
        self._episode = 0

    @property
    def spaces(self) -> Dict[str, dict]:
        """The run config's ``spaces`` block for this env."""
        s = self._screen_size
        channels = 1 if self._grayscale else 3
        return {"obs": {"rgb": {"shape": [s, s, channels], "dtype": "uint8"}},
                "actions": {"n": [self.N_ACTIONS], "continuous": False}}

    def _raw_frame(self, t: int, action: int) -> np.ndarray:
        frame = np.roll(self._base, shift=(t * 2) % self.RAW_SHAPE[0], axis=0)
        sy = (t * 5 + action * 17) % (self.RAW_SHAPE[0] - 12)
        sx = (t * 3 + action * 29) % (self.RAW_SHAPE[1] - 12)
        frame[sy : sy + 12, sx : sx + 12] = 255
        frame[0:4] = 0
        frame[0:4, : 16 * self._lives] = 200
        return frame

    def _deadlines(self) -> List[int]:
        rng = np.random.default_rng(self._seed * 7919 + self._episode)
        jitter = rng.integers(-self._life_len // 4, self._life_len // 4 + 1, size=self._start_lives)
        return list(np.cumsum(self._life_len + jitter))

    def _reward(self, t: int, action: int) -> float:
        step_idx = t // self.frame_skip
        return 1.0 if (step_idx % 13) == ((action * 5 + self._seed) % 13) else 0.0

    def _observe(self, frames: List[np.ndarray]) -> Dict[str, np.ndarray]:
        pooled = np.maximum(frames[-1], frames[-2]) if len(frames) >= 2 else frames[-1]
        frame = resize_area(pooled, self._screen_size, self._screen_size)
        return {"rgb": rgb_to_gray(frame) if self._grayscale else frame}

    def step(self, action):
        action = int(action)
        reward = 0.0
        frames = []
        terminated = False
        for _ in range(self.frame_skip):
            self._t += 1
            reward += self._reward(self._t, action)
            frames.append(self._raw_frame(self._t, action))
            if self._life_deadlines and self._t >= self._life_deadlines[0]:
                self._life_deadlines.pop(0)
                self._lives -= 1
                reward += 10.0
                if self._lives <= 0:
                    terminated = True
                    break
        return self._observe(frames), reward, terminated, False, {"lives": self._lives}

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._seed = int(seed)
            self._episode = 1
        else:
            self._episode += 1
        self._t = 0
        self._lives = self._start_lives
        self._life_deadlines = self._deadlines()
        noops = (self._seed * 31 + self._episode * 13) % (self._noop_max + 1)
        frames = [self._raw_frame(t, 0) for t in range(max(1, noops))]
        self._t = max(0, noops - 1)
        return self._observe(frames[-2:]), {"lives": self._lives}

    def close(self) -> None:
        pass
