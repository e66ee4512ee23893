"""Index arithmetic of the host buffers' draws, on tensors (counterpart of
``sheeprl_tpu/replay/indices.py``).

The host buffers (:mod:`sheeprl_tpu_torch.data.buffers`) sample in two
stages: a raw integer from ``rng.integers(0, n_eligible)`` (numpy PCG64),
then the *eligible-row arithmetic* (wrap-around, the write head's exclusion,
the next-observation shift) that maps it to a storage row. This module is
the second stage as tensor operations, so a step on the card can draw its
rows without the host. Driven from the same seeded numpy generator as a host
buffer, it gives the same rows (``tests/test_torch_replay_indices.py``).
Every function works on tensors of any shape and device, elementwise.
"""

from __future__ import annotations

import torch

__all__ = [
    "uniform_eligible",
    "map_uniform_draw",
    "sequence_eligible",
    "map_sequence_draw",
    "prioritized_end_starts",
    "window_rows",
    "next_rows",
]


def uniform_eligible(pos: torch.Tensor, full: torch.Tensor, capacity: int, sample_next_obs: bool) -> torch.Tensor:
    """The number of rows a uniform draw may take (``ReplayBuffer.sample``):
    when full, every row but the write head's exclusion zone (``capacity``
    rows, ``capacity - 1`` with next-observation sampling); when not full,
    the rows ``[0, pos)`` (one fewer with next-observation sampling)."""
    young = pos - (1 if sample_next_obs else 0)
    old_stop = torch.where(young >= 0, capacity, capacity + young)
    n_full = torch.clamp(young, min=0) + old_stop - pos
    return torch.where(full > 0, n_full, young)


def map_uniform_draw(draw: torch.Tensor, pos: torch.Tensor, full: torch.Tensor, capacity: int,
                     sample_next_obs: bool) -> torch.Tensor:
    """A raw draw in ``[0, uniform_eligible)`` as a storage row: the
    eligible rows are ``[0, young_stop) ++ [pos, old_stop)``, so draws below
    ``young_stop`` stay and the rest shift past the write head; a draw of a
    buffer that is not full is already a row."""
    young = pos - (1 if sample_next_obs else 0)
    mapped = torch.where(draw < young, draw, pos + (draw - torch.clamp(young, min=0)))
    return torch.where(full > 0, mapped, draw)


def sequence_eligible(pos: torch.Tensor, full: torch.Tensor, capacity: int, seq_len: int) -> torch.Tensor:
    """The number of window starts a sequential draw may take
    (``SequentialReplayBuffer.sample``): a window never crosses the write
    head, so ``young_stop = pos - seq_len + 1``."""
    young = pos - seq_len + 1
    old_stop = torch.where(young >= 0, capacity, capacity + young)
    n_full = torch.clamp(young, min=0) + old_stop - pos
    return torch.where(full > 0, n_full, young)


def map_sequence_draw(draw: torch.Tensor, pos: torch.Tensor, full: torch.Tensor, capacity: int,
                      seq_len: int) -> torch.Tensor:
    """A raw draw in ``[0, sequence_eligible)`` as a window's start row (the
    arithmetic of :func:`map_uniform_draw` with the sequential
    ``young_stop``)."""
    young = pos - seq_len + 1
    mapped = torch.where(draw < young, draw, pos + (draw - torch.clamp(young, min=0)))
    return torch.where(full > 0, mapped, draw)


def prioritized_end_starts(draw: torch.Tensor, n_starts: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``prioritize_ends`` on the eligible starts: the draw's domain is
    widened by ``seq_len`` and a draw past the newest start takes the newest
    (``EpisodeBuffer.sample``'s ``upper += sequence_length`` and ``min(start,
    ep_len - sequence_length)``): ``min(draw, n_starts - 1)``."""
    del seq_len  # the widened domain is the caller's draw; the clamp does not need it
    return torch.minimum(draw, n_starts - 1)


def window_rows(start: torch.Tensor, seq_len: int, capacity: int) -> torch.Tensor:
    """The ``(T, B)`` wrapped rows of the windows at the ``(B,)`` starts."""
    steps = torch.arange(seq_len, dtype=start.dtype, device=start.device)
    return (start[None, :] + steps[:, None]) % capacity


def next_rows(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """The rows of the next observations."""
    return (rows + 1) % capacity
