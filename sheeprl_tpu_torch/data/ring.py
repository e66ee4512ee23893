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

The decoupled (Sebulba) topology splits the burst in two: actor threads pack
their rows into append blobs (:func:`make_seq_append_layout`), the learner
appends each blob at the actor's env columns (:func:`build_seq_append_step`)
and trains at its own cadence through the append-free dispatch
(:func:`build_seq_train_step`), drawing windows against the live per-env
heads.

Dreamer V2's episode buffer rides the ring through the episode rule
(:func:`episode_window_table`, :func:`sample_window_starts`): a window
start is valid when its window also holds no interior ``is_first``, so a
window never mixes two episodes. Its deviations from the host
``EpisodeBuffer`` are the JAX package's: starts are uniform over valid
windows (not over episodes), the open episode's prefix can be drawn, and
``prioritize_ends`` stays a host-buffer feature.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlobLayout",
    "build_burst_train_step",
    "build_seq_append_step",
    "build_seq_train_step",
    "effective_stage_buckets",
    "episode_window_table",
    "make_blob_layouts",
    "make_layout",
    "make_seq_append_layout",
    "make_seq_ctl_layout",
    "pack_burst_blob",
    "ring_append_rows",
    "ring_sample_windows",
    "ring_sample_windows_episode",
    "sample_window_starts",
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


def episode_window_table(pos: torch.Tensor, valid_n: torch.Tensor, is_first: torch.Tensor, capacity: int,
                         seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per env, the window starts the episode rule allows: the window
    satisfies the sequential rule (:func:`ring_sample_windows`'s) AND holds
    no episode boundary in its interior (``is_first`` may be 1 only at its
    first row). An env with no boundary-free window falls back to its
    sequential starts (the host buffer would raise; the ring cannot stop).

    Returns ``(table, n_valid)``: ``table`` ``(C, E)`` int32 with each env's
    valid starts packed to the front in ascending order (a stable sort),
    ``n_valid`` ``(E,)`` the count, at least 1. It depends only on the ring
    after a burst's single append, so a burst computes it once and each
    step draws from it with :func:`sample_window_starts`."""
    flags = (is_first.reshape(capacity, -1) > 0).to(torch.int32)  # (C, E)
    # interior[p, e]: any is_first in rows p+1 .. p+seq_len-1 (circular), by a doubled cumsum
    doubled = torch.cat([flags, flags[:seq_len]], dim=0)
    cs = torch.cat([torch.zeros_like(flags[:1]), torch.cumsum(doubled, dim=0, dtype=torch.int32)], dim=0)
    p = torch.arange(capacity, device=flags.device)
    interior = (cs[p + seq_len] - cs[p + 1]) > 0  # (C, E)
    # the sequential rule per position: its distance from the env's oldest row is below the start count
    valid_n, pos = valid_n.to(torch.int32), pos.to(torch.int32)
    full = valid_n >= capacity
    n_starts = torch.where(full, torch.full_like(valid_n, capacity - seq_len + 1), torch.clamp(valid_n - seq_len + 1, min=1))
    base = torch.where(full, pos, torch.zeros_like(pos))
    dist = (p[:, None].to(torch.int32) - base[None, :]) % capacity  # (C, E)
    seq_ok = dist < n_starts[None, :]
    ep_ok = seq_ok & ~interior
    ok = torch.where(ep_ok.any(dim=0)[None, :], ep_ok, seq_ok)
    table = torch.argsort((~ok).to(torch.int8), dim=0, stable=True).to(torch.int32)
    n_valid = torch.clamp(ok.sum(dim=0, dtype=torch.int32), min=1)
    return table, n_valid


def sample_window_starts(u: torch.Tensor, env_idx: torch.Tensor, table: torch.Tensor, n_valid: torch.Tensor,
                         capacity: int, seq_len: int) -> torch.Tensor:
    """A uniform draw from :func:`episode_window_table`'s packed starts:
    ``(T, B)`` int32 time indices for the per-element env choices
    ``env_idx``; ``u`` one uniform in [0, 1) per element, its product with
    the count taken in float32, as JAX takes it."""
    nv = n_valid[env_idx]
    idx = torch.minimum((u.to(torch.float32) * nv.to(torch.float32)).to(torch.int32), nv - 1)
    start = table[idx.long(), env_idx]
    steps = torch.arange(seq_len, dtype=torch.int32, device=start.device)
    return (start[None, :] + steps[:, None]) % capacity


def ring_sample_windows_episode(u: torch.Tensor, env_idx: torch.Tensor, pos: torch.Tensor, valid_n: torch.Tensor,
                                is_first: torch.Tensor, capacity: int, seq_len: int) -> torch.Tensor:
    """The episode rule in one call (the table, then the draw); the burst
    step uses the two halves, the table once per burst."""
    table, n_valid = episode_window_table(pos, valid_n, is_first, capacity, seq_len)
    return sample_window_starts(u, env_idx, table, n_valid, capacity, seq_len)


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


def _train_granted(carry, n: int, sampled_step: Callable, ring_envs: int, ring_batch: int, device,
                   draw_noise: Callable, generator: Optional[torch.Generator], draws: Optional[Dict[str, Any]]):
    """``n`` granted steps of ``sampled_step``, each drawing ``B`` env
    indices, ``B`` window-start uniforms and its noise from ``generator``
    (in that order), unless ``draws`` holds them: ``{"env": (n, B), "u": (n,
    B), "noise": [n noise]}``. Returns the carry and the steps' mean metrics."""
    if draws is None:
        draws = {
            "env": torch.randint(0, ring_envs, (n, ring_batch), generator=generator, device=device),
            "u": torch.rand((n, ring_batch), generator=generator, device=device),
            "noise": [draw_noise(generator) for _ in range(n)],
        }
    metrics = []
    for i in range(n):
        carry, m = sampled_step(carry, draws["env"][i], draws["u"][i], draws["noise"][i])
        metrics.append(m)
    # averaged over the granted steps only; a dict of metrics (the P2E steps') stays a dict
    if isinstance(metrics[0], dict):
        return carry, {k: torch.stack([m[k].to(torch.float32) for m in metrics]).sum(dim=0) / n for k in metrics[0]}
    return carry, torch.stack([m.to(torch.float32) for m in metrics], dim=0).sum(dim=0) / n


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
    steps (a tensor, or a dict of them where the steps return a dict), or
    None when none ran. With ``ring["episode_rule"]`` (Dreamer V2's episode
    buffer) the starts follow the episode rule: the table is computed once,
    after the append, and every step draws from it."""
    # imported here: the kernels package imports the replay package, which imports this module
    from sheeprl_tpu_torch.ops.kernels import ragged_ring_scatter_keys

    capacity = int(ring["capacity"])
    ring_envs = int(ring["n_envs"])
    grad_chunk = int(ring["grad_chunk"])
    ring_seq = int(ring["seq_len"])
    ring_batch = int(ring["batch_size"])
    episode_rule = bool(ring.get("episode_rule", False))
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
        if episode_rule:
            table, n_valid = episode_window_table(new_pos, new_valid, rb["is_first"], capacity, ring_seq)
            sample_starts = lambda uu, env_idx: sample_window_starts(uu, env_idx, table, n_valid, capacity, ring_seq)
        else:
            sample_starts = lambda uu, env_idx: ring_sample_windows(uu, env_idx, new_pos, new_valid, capacity, ring_seq)
        carry, metrics = _train_granted(carry, len(granted), _granted_step(gradient_step, rb, sample_starts),
                                        ring_envs, ring_batch, device, draw_noise, generator, draws)
        return carry, rb, metrics

    return burst_fn


# -- the decoupled (Sebulba) programs: ragged per-env-head appends from
# concurrent actor threads, and the append-free governed train step --------


def make_seq_append_layout(ring_keys: Dict[str, Tuple[tuple, Any]], local_envs: int, stage_rows: int) -> BlobLayout:
    """Byte layout of ONE actor's append blob: ``stage_rows`` staged rows over
    the actor's own ``local_envs`` env columns (regular rows mask every env,
    ragged reset rows only the done envs), the per-row write masks and the
    actor's first env column in the ring (``__offset__``, JAX's layout; the
    port's append takes the offset from the host side of the queued item, so
    nothing reads it back from the card). One size for every block keeps one
    layout for every actor."""
    spec = [(k, (stage_rows, local_envs) + tuple(shape), np.dtype(dtype)) for k, (shape, dtype) in ring_keys.items()]
    spec += [("__mask__", (stage_rows, local_envs), np.int32), ("__offset__", (), np.int32)]
    return make_layout(spec)


def make_seq_ctl_layout(grad_chunk: int) -> BlobLayout:
    """Control blob of the append-free train dispatch: the granted-step mask.
    The port keeps it on the host (the dispatch loops over its granted steps
    in Python); its draws come from the ring's generator."""
    return make_layout([("__validmask__", (grad_chunk,), np.float32)])


def build_seq_append_step(
    ring_keys: Dict[str, Tuple[tuple, Any]], capacity: int, n_envs: int, local_envs: int, stage_rows: int
) -> Tuple[Callable, BlobLayout]:
    """The ragged multi-head append of one actor's blob: ``(append, layout)``
    with ``append(state, blob, col_offset) -> state``.

    ``state`` is the async ring (``storage`` dict of ``(C, E, ...)`` tensors,
    the per-env ``pos``/``valid`` int32 heads, all on one device) and
    ``blob`` one :func:`make_seq_append_layout` upload on that device;
    ``col_offset`` is the actor's first env column, a host ``int``. The
    actor's slice of the heads advances by each column's masked row count
    (:func:`ring_append_rows`: reset rows advance only the done envs), every
    ring key is written by ONE ``ragged_ring_scatter_keys`` launch at
    ``col_offset``, and the slice's new heads are written back: all in place,
    on the current (the learner's) stream, with no read back to the host."""
    from sheeprl_tpu_torch.ops.kernels import ragged_ring_scatter_keys

    layout = make_seq_append_layout(ring_keys, local_envs, stage_rows)
    capacity, n_envs, local_envs = int(capacity), int(n_envs), int(local_envs)

    def append(state: Dict[str, Any], blob: torch.Tensor, col_offset: int) -> Dict[str, Any]:
        off = int(col_offset)
        if off < 0 or off + local_envs > n_envs:
            raise ValueError(f"an append at env column {off} of {local_envs} columns leaves the ring's {n_envs}")
        if blob.numel() != layout.nbytes:
            raise ValueError(f"append blob of {blob.numel()} bytes, the layout holds {layout.nbytes}")
        u = unpack_burst_blob(blob, layout)
        pos_l, valid_l = state["pos"][off:off + local_envs], state["valid"][off:off + local_envs]
        row, new_pos, new_valid = ring_append_rows(pos_l, valid_l, u["__mask__"], capacity)
        ragged_ring_scatter_keys(state["storage"], u, row, pos_l, off)
        pos_l.copy_(new_pos)
        valid_l.copy_(new_valid)
        return state

    return append, layout


def build_seq_train_step(
    gradient_step: Callable[[Any, Any], Any],
    ring: Dict[str, Any],
    draw_noise: Callable[[torch.Generator], Any],
) -> Tuple[Callable, BlobLayout]:
    """Append-free governed train step over the async sequence ring:
    ``(train_fn, ctl_layout)`` with::

        train_fn(carry, state, ctl, host_valid, generator=None, draws=None) -> (carry, metrics)

    ``state`` is the async ring (its storage and the LIVE per-env heads on
    the device, which the append advances), ``ctl`` one host
    :func:`make_seq_ctl_layout` blob, ``host_valid`` the host mirror of the
    valid counts. The gate (no step while any env holds fewer rows than a
    window, the JAX program's in-graph belt) and the granted steps are read
    from the host: nothing is read back from the card. Each granted step
    draws its env indices, window-start uniforms and noise from
    ``generator`` (the ring's) unless ``draws`` holds them, as
    :func:`build_burst_train_step` does, and samples its windows against the
    device heads. The ring is neither copied nor reallocated: the function
    returns only the carry and the steps' mean metrics (None when none
    ran)."""
    capacity = int(ring["capacity"])
    ring_envs = int(ring["n_envs"])
    grad_chunk = int(ring["grad_chunk"])
    ring_seq = int(ring["seq_len"])
    ring_batch = int(ring["batch_size"])
    ctl_layout = make_seq_ctl_layout(grad_chunk)

    def train_fn(carry, state: Dict[str, Any], ctl: torch.Tensor, host_valid,
                 generator: Optional[torch.Generator] = None, draws: Optional[Dict[str, Any]] = None):
        validmask = unpack_burst_blob(ctl, ctl_layout)["__validmask__"]
        ready = bool((np.asarray(host_valid) >= ring_seq).all())
        n = sum(1 for g in range(grad_chunk) if ready and float(validmask[g]) > 0)
        if n == 0:
            return carry, None
        storage, pos, valid = state["storage"], state["pos"], state["valid"]
        sampled_step = _granted_step(
            gradient_step, storage, lambda uu, env_idx: ring_sample_windows(uu, env_idx, pos, valid, capacity, ring_seq)
        )
        return _train_granted(carry, n, sampled_step, ring_envs, ring_batch, pos.device, draw_noise, generator, draws)

    return train_fn, ctl_layout
