"""Device-resident sequence ring for DreamerV3 (counterpart of
``sheeprl_tpu/data/ring.py``: the layout helpers and the coupled burst
program).

Raw transitions stream to a ring in card memory with one write head per env
(pixels stay uint8), windows are drawn on the device with the
``SequentialReplayBuffer`` validity rule, and every env step dispatches the
append plus the granted gradient steps, with no host sampling and no
per-step batch upload.

Packed host->device staging: the staged rows and their masks and heads
become one uint8 blob, so a flush is ONE host->device copy instead of one
per array. :func:`pack_burst_blob` writes a fresh host tensor, pinned when
asked, so a non-blocking copy from it can overlap the host loop (the caching
host allocator holds a pinned block until the copies that read it have run,
so a block is never reused under a copy in flight). :func:`unpack_burst_blob`
slices and reinterprets each segment of the copy: views, no further copy.
The segments start at 4-byte aligned offsets only.

Left for later slices: the episode rule (``episode_window_table``,
``sample_window_starts``) and the decoupled programs
(``build_seq_append_step``, ``build_seq_train_step``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlobLayout",
    "build_burst_train_step",
    "effective_stage_buckets",
    "make_blob_layouts",
    "make_layout",
    "pack_burst_blob",
    "ring_append_rows",
    "ring_sample_windows",
    "torch_dtype",
    "unpack_burst_blob",
]


def ring_append_rows(pos: torch.Tensor, valid_n: torch.Tensor, staged_mask: torch.Tensor, capacity: int):
    """Per-env ragged ring-append indices.

    Slot ``i`` writes env ``e`` iff ``staged_mask[i, e]``; each env's rows
    pack densely from its own write head (as ``EnvIndependentReplayBuffer``'s
    ragged adds do). Returns the ``(S, E)`` int32 row indices (``capacity``
    marks dropped and padded slots), the new per-env write heads and the new
    per-env valid counts."""
    pos, valid_n = pos.to(torch.int32), valid_n.to(torch.int32)
    counts = torch.cumsum(staged_mask.to(torch.int32), dim=0, dtype=torch.int32)  # (S, E)
    row = (pos[None, :] + counts - 1) % capacity
    row = torch.where(staged_mask > 0, row, torch.full_like(row, capacity))
    new_pos = (pos + counts[-1]) % capacity
    new_valid = torch.clamp(valid_n + counts[-1], max=capacity)
    return row, new_pos, new_valid


def ring_sample_windows(
    u: torch.Tensor, env_idx: torch.Tensor, pos: torch.Tensor, valid_n: torch.Tensor, capacity: int, seq_len: int
) -> torch.Tensor:
    """Uniform sequence-window starts with the ``SequentialReplayBuffer``
    validity rule: a window never crosses its env's write head (the
    oldest-to-newest boundary once the ring is full). ``u`` holds one
    uniform in [0, 1) per element (the JAX package draws it from its key
    here); the product with the start count is taken in float32, as JAX
    takes it. Returns ``(T, B)`` int32 time indices for the per-element env
    choices ``env_idx``."""
    vn = valid_n[env_idx]
    full = vn >= capacity
    n_starts = torch.where(full, torch.full_like(vn, capacity - seq_len + 1), torch.clamp(vn - seq_len + 1, min=1))
    base = torch.where(full, pos[env_idx], torch.zeros_like(vn))
    start = (base + (u.to(torch.float32) * n_starts.to(torch.float32)).to(torch.int32)) % capacity
    steps = torch.arange(seq_len, dtype=torch.int32, device=start.device)
    return (start[None, :] + steps[:, None]) % capacity


def effective_stage_buckets(stage_buckets, stage_max: int) -> Tuple[int, ...]:
    """The normalized flush-bucket set (always ends with ``stage_max``), so
    the host packer and the device unpacker never disagree on bucket sizes."""
    buckets = sorted(set(int(b) for b in (stage_buckets or ()) if 0 < int(b) <= int(stage_max)))
    if not buckets or buckets[-1] < int(stage_max):
        buckets.append(int(stage_max))
    return tuple(buckets)


class BlobLayout(NamedTuple):
    """Byte layout of one packed upload."""

    nbytes: int
    segments: Tuple[Tuple[str, int, tuple, Any], ...]  # (name, offset, shape, np.dtype)


def make_layout(spec) -> BlobLayout:
    """Build a :class:`BlobLayout` from ``(name, shape, dtype)`` triples.

    Segment offsets are 4-byte aligned so 32-bit segments can be
    reinterpreted from the uint8 view; the total length is padded to a
    4-byte multiple."""
    segs = []
    off = 0
    for name, shape, dtype in spec:
        off = (off + 3) & ~3
        segs.append((name, off, tuple(int(s) for s in shape), np.dtype(dtype)))
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return BlobLayout((off + 3) & ~3, tuple(segs))


def make_blob_layouts(
    ring_keys: Dict[str, Tuple[tuple, Any]], n_envs: int, grad_chunk: int, buckets: Tuple[int, ...]
) -> Dict[int, BlobLayout]:
    """Per-bucket byte layouts of the one upload a burst dispatch takes:
    the staged rows of every ring key, the ``(size, n_envs)`` write masks,
    the per-env heads and valid counts, and the granted-step mask. The JAX
    package's blob also carries the dispatch's PRNG key; the port's draws
    come from the ring's own generator on the device, so its blob has none.

    Returns ``{bucket_size: BlobLayout}``. Blob lengths are unique across
    buckets: the length selects the layout on the device side."""
    layouts: Dict[int, BlobLayout] = {}
    seen_lengths = set()
    for size in buckets:
        spec = [(k, (size, n_envs) + tuple(shape), dtype) for k, (shape, dtype) in ring_keys.items()]
        spec += [
            ("__mask__", (size, n_envs), np.int32),
            ("__pos__", (n_envs,), np.int32),
            ("__valid_n__", (n_envs,), np.int32),
            ("__validmask__", (grad_chunk,), np.float32),
        ]
        layout = make_layout(spec)
        total = layout.nbytes
        while total in seen_lengths:
            total += 4
        seen_lengths.add(total)
        layouts[int(size)] = BlobLayout(total, layout.segments)
    return layouts


def pack_burst_blob(layout: BlobLayout, values: Dict[str, np.ndarray], pin_memory: bool = False) -> torch.Tensor:
    """Host side: copy every segment's bytes into one fresh uint8 tensor
    (pinned with ``pin_memory``, which needs a CUDA build)."""
    blob = torch.zeros(layout.nbytes, dtype=torch.uint8, pin_memory=pin_memory)
    view = blob.numpy()
    for name, off, shape, dtype in layout.segments:
        arr = np.ascontiguousarray(values[name], dtype=dtype)
        view[off : off + arr.nbytes] = arr.view(np.uint8).ravel()
    return blob


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def unpack_burst_blob(blob: torch.Tensor, layout: BlobLayout) -> Dict[str, torch.Tensor]:
    """Device side: each segment as a view of ``blob`` in its dtype and shape."""
    out = {}
    for name, off, shape, dtype in layout.segments:
        seg = blob[off : off + int(np.prod(shape)) * dtype.itemsize]
        out[name] = (seg if dtype == np.uint8 else seg.view(torch_dtype(dtype))).reshape(shape)
    return out


def _granted_step(gradient_step: Callable, storage: Dict[str, torch.Tensor], sample_starts: Callable) -> Callable:
    """One granted gradient step on a window drawn from the ring:
    ``step(carry, env_idx, u, noise) -> (carry, metrics)``. ``sample_starts(u,
    env_idx)`` gives the ``(T, B)`` time indices; the gathered window is cast
    to float32 for the train body (pixels stay in [0, 255]). The gather is
    plain indexing, as it is plain indexing outside Pallas in the JAX
    package, on the stream that has just appended."""

    def sampled_step(carry, env_idx: torch.Tensor, u: torch.Tensor, noise: Any):
        t_idx = sample_starts(u, env_idx)
        batch = {k: v[t_idx, env_idx[None, :]].to(torch.float32) for k, v in storage.items()}
        return gradient_step(carry, (batch, noise))

    return sampled_step


def build_burst_train_step(
    gradient_step: Callable[[Any, Any], Any],
    ring: Dict[str, Any],
    draw_noise: Callable[[torch.Generator], Any],
) -> Callable:
    """Wrap an algorithm's per-gradient-step update into a ring-owning burst
    step (the coupled topology's one dispatch per env step).

    ``gradient_step(carry, (batch, noise)) -> (carry, metrics)`` is the
    algorithm's step body on a ``(T, B, ...)`` float32 batch; ``draw_noise(
    generator)`` draws one step's noise. The returned function::

        burst_fn(carry, rb, blob, generator=None, draws=None) -> (carry, rb, metrics)

    takes the ring ``rb`` (``{key: (C, E, ...)}`` on the device, appended in
    place) and one packed host blob (:func:`make_blob_layouts`; its length
    selects the layout). It copies the blob to the ring's device, appends
    the staged rows of every ring key with one ``ragged_ring_scatter_keys``
    launch, then runs each granted step of the blob's ``__validmask__``, gated as
    the JAX program gates it: no step while any env holds fewer rows than a
    window. The mask, the heads and so the gate are read from the host copy
    of the blob: nothing is read back from the device. Each step draws
    ``B`` env indices, ``B`` window-start uniforms and its noise from
    ``generator`` (the ring's), unless ``draws`` holds them:
    ``{"env": (G, B), "u": (G, B), "noise": [G noise]}`` for the G granted
    steps. ``metrics`` is the mean of the steps' metrics over the granted
    steps, or None when none ran."""
    # imported here: the kernels package imports the replay package, which imports this module
    from sheeprl_tpu_torch.ops.kernels import ragged_ring_scatter_keys

    capacity = int(ring["capacity"])
    ring_envs = int(ring["n_envs"])
    grad_chunk = int(ring["grad_chunk"])
    ring_seq = int(ring["seq_len"])
    ring_batch = int(ring["batch_size"])
    ring_keys = ring["ring_keys"]
    buckets = tuple(int(b) for b in ring["stage_buckets"])
    layouts = make_blob_layouts(
        ring_keys, ring_envs, grad_chunk, effective_stage_buckets(buckets, int(ring.get("stage_max", max(buckets))))
    )
    by_length = {layout.nbytes: layout for layout in layouts.values()}

    def burst_fn(carry, rb: Dict[str, torch.Tensor], blob: torch.Tensor,
                 generator: Optional[torch.Generator] = None, draws: Optional[Dict[str, Any]] = None):
        layout = by_length[blob.numel()]
        device = next(iter(rb.values())).device
        host = unpack_burst_blob(blob, layout)
        u = unpack_burst_blob(blob.to(device, non_blocking=True), layout)
        # -- per-env ring append: each env's rows pack densely from its own head
        row, new_pos, new_valid = ring_append_rows(u["__pos__"], u["__valid_n__"], u["__mask__"], capacity)
        ragged_ring_scatter_keys(rb, u, row, u["__pos__"])
        # the in-graph gate of the JAX program, on the host copy of the same numbers
        _, _, host_valid = ring_append_rows(host["__pos__"], host["__valid_n__"], host["__mask__"], capacity)
        ready = bool((host_valid >= ring_seq).all())
        granted: List[int] = [g for g in range(grad_chunk) if ready and float(host["__validmask__"][g]) > 0]
        if not granted:
            return carry, rb, None
        if draws is None:
            n = len(granted)
            draws = {
                "env": torch.randint(0, ring_envs, (n, ring_batch), generator=generator, device=device),
                "u": torch.rand((n, ring_batch), generator=generator, device=device),
                "noise": [draw_noise(generator) for _ in granted],
            }
        sampled_step = _granted_step(
            gradient_step, rb, lambda uu, env_idx: ring_sample_windows(uu, env_idx, new_pos, new_valid, capacity, ring_seq)
        )
        metrics = []
        for i in range(len(granted)):
            carry, m = sampled_step(carry, draws["env"][i], draws["u"][i], draws["noise"][i])
            metrics.append(m.to(torch.float32))
        # averaged over the granted steps only
        return carry, rb, torch.stack(metrics, dim=0).sum(dim=0) / max(len(granted), 1)

    return burst_fn
