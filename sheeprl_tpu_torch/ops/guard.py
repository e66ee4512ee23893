"""Finite guard for train steps (counterpart of ``sheeprl_tpu/ops/guard.py``).

:func:`finite_guard` reduces tensors to one 0-dim bool on their device ("every
floating tensor is finite") without reading anything back to the host, so
the verdict can steer a select inside the step. :class:`StateGuard` keeps a
copy of a train state (parameters, optimizer moments and step counts) and
puts it back, NaN-safe, where the verdict is False: a poisoned minibatch
becomes a no-op update whose occurrence the step counts instead of
spreading NaNs into the parameters.

The verdict is taken from each tensor's max-abs (``torch._foreach_norm``
with ``ord=inf``, which keeps NaN), not from a squared 2-norm: a finite
gradient holding 1e20 has an infinite 2-norm and a finite max-abs, and the
JAX guard (``isfinite().all()`` per leaf) takes that step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["finite_guard", "guarded_select", "StateGuard"]


def finite_guard(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-dim bool on the tensors' device: True iff every floating-point
    tensor holds no NaN and no Inf. Other tensors are ignored."""
    ts = [t.detach() for t in tensors if t is not None and t.is_floating_point()]
    if not ts:
        raise ValueError("finite_guard needs at least one floating-point tensor")
    return torch.isfinite(torch.stack(torch._foreach_norm(ts, float("inf")))).all()


def guarded_select(ok: torch.Tensor, new: Sequence[torch.Tensor], old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``new`` where ``ok`` else ``old``, tensor by tensor. A select, not a
    blend: ``old + ok * (new - old)`` would keep a NaN of ``new``."""
    return [torch.where(ok, n, o) for n, o in zip(new, old)]


class _Group:
    """The tensors of one (device, dtype) as two flat buffers: ``old``, the
    state a skipped step returns to, and ``new``, the state after the step."""

    def __init__(self, index: List[int], tensors: List[torch.Tensor]) -> None:
        self.index = index
        sizes = [t.numel() for t in tensors]
        like = tensors[0]
        self.old = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
        self.new = torch.empty_like(self.old)
        self.old_views = [v.view(t.shape) for v, t in zip(self.old.split(sizes), tensors)]
        self.new_views = [v.view(t.shape) for v, t in zip(self.new.split(sizes), tensors)]


class StateGuard:
    """Snapshot and NaN-safe restore of a train state in a few launches per
    (device, dtype) group, whatever the number of tensors.

    ``collect()`` returns the state's tensors (the same shapes, in the same
    order, at every call; the objects may change, as an optimizer's
    ``load_state_dict`` replaces them). :meth:`snapshot` copies them into
    the ``old`` buffer with one multi-tensor copy. :meth:`select` copies the
    stepped state into the ``new`` buffer, takes ``where(ok, new, old)``
    over the flat buffer into ``old`` with one launch, and copies ``old``
    back into the tensors with one multi-tensor copy; ``old`` then holds the
    live state again, so consecutive guarded steps need no snapshot between
    them. Snapshot again after anything else writes the state (a load, a
    rollback)."""

    def __init__(self, collect: Callable[[], List[torch.Tensor]]) -> None:
        self.collect = collect
        self._groups: List[_Group] = []
        self._layout: List[Tuple[torch.Size, torch.dtype, torch.device]] = []

    def _tensors(self) -> List[torch.Tensor]:
        tensors = [t.detach() for t in self.collect()]
        layout = [(t.shape, t.dtype, t.device) for t in tensors]
        if layout != self._layout:
            by_key: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
            for i, t in enumerate(tensors):
                by_key.setdefault((t.dtype, t.device), []).append(i)
            self._groups = [_Group(idx, [tensors[i] for i in idx]) for idx in by_key.values()]
            self._layout = layout
        return tensors

    def snapshot(self) -> None:
        tensors = self._tensors()
        for g in self._groups:
            torch._foreach_copy_(g.old_views, [tensors[i] for i in g.index])

    def select(self, ok: torch.Tensor) -> None:
        tensors = self._tensors()
        for g in self._groups:
            live = [tensors[i] for i in g.index]
            torch._foreach_copy_(g.new_views, live)
            torch.where(ok.to(g.old.device), g.new, g.old, out=g.old)
            torch._foreach_copy_(live, g.old_views)
