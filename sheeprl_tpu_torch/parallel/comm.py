"""Cross-process gradient reduction (counterpart of
``sheeprl_tpu/parallel/comm.py``).

Every data-parallel gradient step mean-reduces its gradients over the group
before the optimizer's clip and update, as the JAX steps ``pmean`` theirs
over ``dp`` before ``tx.update``. :func:`pmean_grads` packs the gradients
into ONE flat buffer in the wire dtype, reduces it with ONE ``all_reduce``
(SUM, then a division by the world size in the wire dtype, as ``pmean`` of
the cast gradients divides), and unpacks each gradient back to its own
dtype. ``fabric.grad_reduce_dtype`` picks the wire: float32 (the gradients'
own dtype) or bfloat16, which halves the bytes and rounds only the
averaging; parameters, optimizer state and the local backward stay float32.

The group is gloo (:mod:`~sheeprl_tpu_torch.parallel.distributed`). On the
card the flat buffer crosses to a pinned host buffer of its own, kept per
size and dtype, is reduced there and crosses back: the staging is explicit,
not gloo's, so the path is the same whatever a torch build's gloo accepts,
and each reduction costs one device-to-host copy, one wait for it, the
collective and one host-to-device copy. At world size 1 every function
returns its input unchanged, with no collective and no copy.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist

from sheeprl_tpu_torch.parallel.distributed import world_size

__all__ = [
    "WIRE_SPELLINGS",
    "parse_grad_reduce_dtype",
    "set_grad_reduce_dtype",
    "get_grad_reduce_dtype",
    "pmean_grads",
    "pmean_grads_with_verdict",
    "all_gather_wire",
    "all_gather_rows",
    "all_reduce_mean",
    "all_reduce_max",
    "all_true",
    "all_gather_exact",
    "broadcast_flag",
    "barrier",
    "REDUCTIONS",
]

#: the JAX package's spellings of each wire dtype (``None``: the gradients' own)
WIRE_SPELLINGS = {
    "float32": None, "f32": None, "fp32": None, "32": None, "none": None,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}

_WIRE: Optional[torch.dtype] = None
# the wire dtypes the gradients were reduced with since the run began: the
# counterpart of the JAX module's trace record, for the mid-run warning
_REDUCED_WITH: Set[Optional[torch.dtype]] = set()
# pinned host buffers of the card's reductions, by (numel, dtype)
_STAGING: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

#: reductions made in this process: calls, bytes on the wire
REDUCTIONS: Dict[str, int] = {"calls": 0, "bytes": 0}


def _wire(spec: str) -> Optional[torch.dtype]:
    name = str(spec).lower()
    if name not in WIRE_SPELLINGS:
        raise ValueError(f"Unsupported fabric.grad_reduce_dtype: {spec!r} (float32 or bfloat16)")
    return WIRE_SPELLINGS[name]


def parse_grad_reduce_dtype(spec: Optional[str]) -> "Optional[torch.dtype] | str":
    """``fabric.grad_reduce_dtype`` -> the wire dtype (``None`` for the
    gradients' own float32), or ``"auto"`` for ``auto`` and null. Anything
    else raises the JAX package's ``ValueError``."""
    if spec is None or str(spec).lower() == "auto":
        return "auto"
    return _wire(spec)


def set_grad_reduce_dtype(dtype_str: Optional[str], fresh_run: bool = False) -> None:
    """Set the wire dtype from one of the JAX spellings (null is float32).
    ``fresh_run=True`` (how the run's fabric setup calls it) marks a run
    boundary: earlier runs' reductions in this process are forgotten. A
    change of wire after this run's gradients were already reduced warns, as
    the JAX package warns of steps traced with the old one: the setting is
    meant to be made once, before the first step."""
    global _WIRE
    new = _wire(dtype_str or "float32")
    if fresh_run:
        _REDUCED_WITH.clear()
    elif any(t != new for t in _REDUCED_WITH):
        warnings.warn(
            "fabric.grad_reduce_dtype changed after this run's gradients were already reduced; "
            "the earlier steps kept the previous wire dtype. Set it once, before launch."
        )
        _REDUCED_WITH.clear()
    _WIRE = new


def get_grad_reduce_dtype() -> Optional[torch.dtype]:
    """The wire dtype, ``None`` for the gradients' own."""
    return _WIRE


def _stage(flat: torch.Tensor) -> torch.Tensor:
    """The host tensor the collective runs on: ``flat`` itself on the CPU,
    else this size's pinned buffer, filled from the card (the copy waited
    for)."""
    if flat.device.type == "cpu":
        return flat
    key = (flat.numel(), flat.dtype)
    host = _STAGING.get(key)
    if host is None:
        host = _STAGING[key] = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host


def _all_reduce_sum(flat: torch.Tensor) -> None:
    """SUM ``flat`` over the group, in place, through :func:`_stage`."""
    host = _stage(flat)
    dist.all_reduce(host)
    REDUCTIONS["calls"] += 1
    REDUCTIONS["bytes"] += host.numel() * host.element_size()
    if host is not flat:
        flat.copy_(host, non_blocking=True)


def _reduce(grads: Sequence[torch.Tensor], extra: Optional[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    wire = _WIRE or grads[0].dtype
    _REDUCED_WITH.add(_WIRE)
    parts = [g.reshape(-1).to(wire) for g in grads]
    if extra is not None:
        parts.append(extra.reshape(1).to(wire))
    flat = torch.cat(parts)
    _all_reduce_sum(flat)
    n = flat.numel() - (extra is not None)
    mean = flat[:n].div_(world_size())
    out, offset = [], 0
    for g in grads:
        out.append(mean[offset:offset + g.numel()].view(g.shape).to(g.dtype))
        offset += g.numel()
    return out, flat[n:]


def pmean_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each gradient over the group (see the module docstring):
    one flat buffer, one ``all_reduce``. At world size 1, ``grads`` itself."""
    if world_size() == 1:
        return list(grads)
    return _reduce(grads, None)[0]


def pmean_grads_with_verdict(grads: Sequence[torch.Tensor], ok: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """:func:`pmean_grads` and the group's finite verdict: ``ok`` is this
    rank's (a 0-dim bool on the gradients' device), and the verdict returned
    is True iff it is True on every rank (the JAX step's ``pmin`` over
    ``dp``), so every rank takes the same branch and the parameters stay
    bit-equal. The verdict rides the gradients' ``all_reduce`` as one more
    element, the count of ranks whose verdict is False, so the guard adds no
    collective. At world size 1, ``(grads, ok)``."""
    if world_size() == 1:
        return list(grads), ok
    out, bad = _reduce(grads, (~ok).to(torch.float32))
    return out, (bad[0] == 0)


def all_gather_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank stacked on a new leading axis ``(W, *x.shape)``,
    on the wire dtype (the JAX ``all_gather_wire``: the values cross in
    bfloat16 under a bfloat16 wire) and cast back to ``x``'s. At world size
    1, ``x[None]``."""
    if world_size() == 1:
        return x[None]
    wire = _WIRE or x.dtype
    return all_gather_rows(x.to(wire)[None]).to(x.dtype)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the first axis in rank order
    (``lax.all_gather(..., tiled=True)``), exactly, through host memory. At
    world size 1, ``x``."""
    w = world_size()
    if w == 1:
        return x
    host = x.detach().contiguous().cpu()
    parts = [torch.empty_like(host) for _ in range(w)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(x.device)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the group (losses; ``lax.pmean``), exact in
    ``x``'s dtype up to the sum's rounding. At world size 1, ``x``."""
    w = world_size()
    if w == 1:
        return x
    host = x.detach().to(torch.float32).cpu().clone()
    dist.all_reduce(host)
    return (host / w).to(x.dtype).to(x.device)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group (``lax.pmax``),
    exact: a maximum rounds nothing, and ``x`` crosses in its own dtype,
    never the gradient wire's. At world size 1, ``x``."""
    if world_size() == 1:
        return x
    host = x.detach().contiguous().cpu().clone()
    dist.all_reduce(host, op=dist.ReduceOp.MAX)
    return host.to(x.device)


def all_true(flag: bool) -> bool:
    """True iff ``flag`` is True on every rank (a host decision every rank
    must take alike, such as a ring's sampling gate). At world size 1,
    ``flag``."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def all_gather_exact(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Every rank's 1-D ``xs`` concatenated in rank order, each in its own
    dtype and bit for bit (``lax.all_gather(..., tiled=True)`` of each), in
    ONE collective: the tensors are packed into one int64 buffer (an int64
    as itself, a 32-bit float or int by its bits), so nothing crosses the
    gradient wire's dtype. Every rank must pass tensors of the same
    lengths. At world size 1, ``xs``."""
    if world_size() == 1:
        return tuple(xs)
    parts = []
    for x in xs:
        x = x.detach().reshape(-1).cpu()
        if x.dtype == torch.int64:
            parts.append(x)
        elif x.element_size() == 4:
            parts.append(x.contiguous().view(torch.int32).to(torch.int64))
        else:
            raise TypeError(f"all_gather_exact takes int64 and 32-bit tensors, got {x.dtype}")
    packed = all_gather_rows(torch.cat(parts)[None]).view(world_size(), -1)
    out, offset = [], 0
    for x, part in zip(xs, parts):
        n = part.numel()
        cols = packed[:, offset:offset + n].reshape(-1)
        offset += n
        if x.dtype != torch.int64:
            cols = cols.to(torch.int32).view(x.dtype)
        out.append(cols.to(x.device))
    return tuple(out)


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank (the JAX loop's broadcast of
    rank 0's drain flag). At world size 1, ``flag``."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.broadcast(t, src=src)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (a no-op at world size 1)."""
    if world_size() > 1:
        dist.barrier()
