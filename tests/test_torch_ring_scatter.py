"""The port's ragged ring scatter (``sheeprl_tpu_torch/ops/kernels/scatter.py``)
and the sequence ring's index math and sizing (``data/ring.py``,
``replay/device_buffer.py``) against the JAX package's, on the CPU.

The scatter's plain version (what a CPU tensor runs) is held bit-equal to
JAX's ``backend="lax"`` and ``backend="pallas"`` (interpret mode, as
``tests/test_ops/test_kernels.py`` runs it) at uint8 and float32, slots of
1, 18 and 12,288 elements, 1 and 2 staged rows, 1 and 4 envs, column
offset 0 and 2, dropped slots, an all-dropped column and heads that wrap
past the capacity; rows the call does not write, and the row before each
env's head, keep their bytes. Its gradient matches ``jax.vjp`` of the lax
reference within 1e-6 (the values are copies: in practice it is equal).
``ragged_ring_scatter_keys`` (every key of a ring in one launch on the
card) on CPU tensors equals the JAX package's per-key dict comprehension
(``sheeprl_tpu/data/ring.py:320``) key for key, bit for bit, with 1, 2 and
5 keys of mixed dtypes and slot sizes; its gradient through the
``autograd.Function`` the card runs (the launch swapped for the plain
version) equals the per-key plain scatter's; its checks raise.
``ring_append_rows`` and ``ring_sample_windows`` (given JAX's own
uniforms), the blob layouts' ring-key segments and ``estimate_ring_bytes``
with the sequence accounting are equal to JAX's exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.data.ring import ring_append_rows as jax_ring_append_rows
from sheeprl_tpu.data.ring import ring_sample_windows as jax_ring_sample_windows
from sheeprl_tpu.ops import kernels as JK
from sheeprl_tpu.replay import estimate_ring_bytes as jax_estimate
from sheeprl_tpu.replay import resolve_device_resident as jax_resolve
from sheeprl_tpu.utils.burst import dreamer_ring_keys as jax_dreamer_ring_keys
from sheeprl_tpu_torch.data.ring import (
    effective_stage_buckets,
    make_blob_layouts,
    ring_append_rows,
    ring_sample_windows,
)
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.replay import estimate_ring_bytes, resolve_device_resident
from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

C = 11
# the module that holds the private launch the gradient test swaps
scatter_module = importlib.import_module("sheeprl_tpu_torch.ops.kernels.scatter")


def _case(seed, S, e, feat, dtype, col_offset, drop, wrap):
    """A ring of ``C`` rows and ``e + col_offset`` env columns, staged
    ``(S, e)`` rows and their ``ring_append_rows`` indices (JAX's)."""
    rng = np.random.default_rng(seed)
    E = e + col_offset
    if dtype == np.uint8:
        storage = rng.integers(0, 256, (C, E) + feat).astype(np.uint8)
        staged = rng.integers(0, 256, (S, e) + feat).astype(np.uint8)
    else:
        storage = rng.normal(size=(C, E) + feat).astype(np.float32)
        staged = rng.normal(size=(S, e) + feat).astype(np.float32)
    mask = np.ones((S, e), np.int32)
    if drop == "ragged":
        mask[S - 1, ::2] = 0
    elif drop == "column":
        mask[:, 0] = 0
    pos = np.full(e, C - 1, np.int32) if wrap else rng.integers(0, C, e).astype(np.int32)
    valid = np.full(e, C, np.int32)
    row, _, _ = jax_ring_append_rows(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(mask), C)
    return storage, staged, np.array(row), pos


CASES = [
    (dtype, feat, S, e, off, drop, wrap)
    for dtype in (np.uint8, np.float32)
    for feat in ((1,), (18,), (64, 64, 3))
    for S in (1, 2)
    for e in (1, 4)
    for off in (0, 2)
    for drop, wrap in (("none", True), ("ragged", False), ("column", True))
    if not (drop == "column" and e == 1)
]


def _case_id(c):
    dtype, feat, S, e, off, drop, wrap = c
    return f"{np.dtype(dtype).name}-F{int(np.prod(feat))}-S{S}-e{e}-off{off}-{drop}{'-wrap' if wrap else ''}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_torch_ring_scatter_is_bit_equal_to_jax_lax_and_pallas(case):
    dtype, feat, S, e, off, drop, wrap = case
    storage, staged, row, pos = _case(len(feat) * 100 + S * 10 + e, S, e, feat, dtype, off, drop, wrap)
    want_lax = np.asarray(JK.ragged_ring_scatter(jnp.asarray(storage), jnp.asarray(staged), jnp.asarray(row),
                                                 jnp.asarray(pos), off, backend="lax"))
    want_pallas = np.asarray(JK.ragged_ring_scatter(jnp.asarray(storage), jnp.asarray(staged), jnp.asarray(row),
                                                    jnp.asarray(pos), off, backend="pallas"))
    ring = torch.from_numpy(storage.copy())
    out = K.ragged_ring_scatter(ring, torch.from_numpy(staged), torch.from_numpy(row), torch.from_numpy(pos), off)
    assert out is ring  # in place, as the Pallas version aliases the ring
    np.testing.assert_array_equal(out.numpy(), want_lax)
    np.testing.assert_array_equal(out.numpy(), want_pallas)
    # untouched slots, and the row before each env's head, keep their bytes
    touched = np.zeros((C, e + off), bool)
    for s in range(S):
        for j in range(e):
            if row[s, j] < C:
                touched[row[s, j], off + j] = True
    np.testing.assert_array_equal(out.numpy()[~touched], storage[~touched])
    for j in range(e):
        r = (pos[j] - 1) % C
        if not touched[r, off + j]:
            np.testing.assert_array_equal(out.numpy()[r, off + j], storage[r, off + j])
    assert K.LAUNCHES["ragged_ring_scatter"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("off", [0, 2])
@pytest.mark.parametrize("drop", ["ragged", "column"])
def test_torch_ring_scatter_gradient_matches_jax_vjp(off, drop):
    storage, staged, row, pos = _case(7, 2, 4, (3,), np.float32, off, drop, wrap=False)
    g = np.random.default_rng(8).normal(size=storage.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda s, t: JK.ragged_ring_scatter(s, t, jnp.asarray(row), jnp.asarray(pos), off, backend="pallas"),
        jnp.asarray(storage), jnp.asarray(staged),
    )
    want_s, want_t = vjp(jnp.asarray(g))
    s = torch.from_numpy(storage).requires_grad_(True)
    t = torch.from_numpy(staged).requires_grad_(True)
    out = K.ragged_ring_scatter(s.clone(), t, torch.from_numpy(row), torch.from_numpy(pos), off)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t), rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity", [5, 64])
def test_torch_ring_append_rows_match_jax(capacity):
    """A stream of ragged masks through both: rows, heads and valid counts
    equal at every step, through wraps and a full ring."""
    rng = np.random.default_rng(capacity)
    E = 4
    pos, valid = np.zeros(E, np.int32), np.zeros(E, np.int32)
    for _ in range(40):
        S = int(rng.integers(1, 3))
        mask = (rng.random((S, E)) < 0.7).astype(np.int32)
        want = [np.asarray(a) for a in jax_ring_append_rows(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(mask), capacity)]
        got = [a.numpy() for a in ring_append_rows(torch.from_numpy(pos), torch.from_numpy(valid), torch.from_numpy(mask), capacity)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].dtype == np.int32
        pos, valid = got[1], got[2]


@pytest.mark.parametrize("capacity, seq_len", [(64, 8), (1000, 64), (100_000, 64)])
def test_torch_ring_sample_windows_match_jax_given_its_uniforms(capacity, seq_len):
    """JAX draws its start uniforms from the key; given the same uniforms
    the port's windows are JAX's, for full and filling envs (the start is
    taken in float32: a float64 product would truncate to other starts at
    the large ring)."""
    rng = np.random.default_rng(seq_len)
    E, B = 3, 256
    pos = rng.integers(0, capacity, E).astype(np.int32)
    valid = np.array([capacity, seq_len + 3, capacity], np.int32)
    for i in range(4):
        key = jax.random.PRNGKey(i)
        env_idx = rng.integers(0, E, B).astype(np.int32)
        want = np.asarray(jax_ring_sample_windows(key, jnp.asarray(env_idx), jnp.asarray(pos), jnp.asarray(valid),
                                                  capacity, seq_len))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B,))))
        got = ring_sample_windows(u, torch.from_numpy(env_idx).long(), torch.from_numpy(pos), torch.from_numpy(valid),
                                  capacity, seq_len)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (seq_len, B)


def _ring_keys(port: bool):
    space = {"rgb": {"shape": [64, 64, 3]}, "state": {"shape": [10]}}
    if port:
        return dreamer_ring_keys(space, ["rgb"], ["state"], (3, 2), with_is_first=True)
    import gymnasium as gym

    obs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
                           "state": gym.spaces.Box(-1, 1, (10,), np.float32)})
    return jax_dreamer_ring_keys(obs, ["rgb"], ["state"], (3, 2), with_is_first=True)


def test_torch_ring_keys_and_blob_layouts_match_jax():
    """The ring keys (order, shapes, dtypes) and each bucket's ring-key,
    mask and head segments (offsets, shapes, dtypes) equal JAX's; the port's
    blob has no key segment and every bucket's length is unique."""
    port, jax_keys = _ring_keys(True), _ring_keys(False)
    assert list(port) == list(jax_keys)
    for k in port:
        assert port[k][0] == jax_keys[k][0] and np.dtype(port[k][1]) == np.dtype(jax_keys[k][1])
    buckets = effective_stage_buckets((1, 2), 2)
    assert buckets == (1, 2)
    for n_envs, grad_chunk in ((1, 1), (3, 2)):
        got = make_blob_layouts(port, n_envs, grad_chunk, buckets)
        want = jax_make_blob_layouts(jax_keys, n_envs, grad_chunk, buckets)
        assert set(got) == set(want)
        for size in buckets:
            jax_segs = {name: (off, shape, np.dtype(dt)) for name, off, shape, dt in want[size].segments}
            segs = {name: (off, shape, np.dtype(dt)) for name, off, shape, dt in got[size].segments}
            assert "__key__" not in segs and set(segs) == set(jax_segs) - {"__key__"}
            for name in list(port) + ["__mask__", "__pos__", "__valid_n__"]:
                assert segs[name] == jax_segs[name], name
            assert segs["__validmask__"][1:] == jax_segs["__validmask__"][1:]
        assert len({layout.nbytes for layout in got.values()}) == len(buckets)


@pytest.mark.parametrize("capacity, n_envs, seq_len, batch", [(100_000, 1, 64, 16), (4096, 4, 16, 8), (64, 2, 4, 2)])
def test_torch_sequence_ring_sizing_matches_jax(capacity, n_envs, seq_len, batch):
    port, jax_keys = _ring_keys(True), _ring_keys(False)
    seq = {"seq_len": seq_len, "batch_size": batch}
    want = jax_estimate(jax_keys, capacity, n_envs, 1, False, False, sequence=seq)
    assert estimate_ring_bytes(port, capacity, n_envs, sequence=seq) == want
    assert estimate_ring_bytes(port, capacity, n_envs) == jax_estimate(jax_keys, capacity, n_envs)
    for budget in (want / 2**30 * 1.01, want / 2**30 * 0.99):
        got = resolve_device_resident("auto", port, capacity, n_envs, budget, sequence=seq)
        jax_got = jax_resolve("auto", jax_keys, capacity, n_envs, 1, budget, allow_shard=False, sequence=seq)
        assert got[0] == jax_got[0]


def test_torch_sequence_ring_full_recipe_fits_its_budget():
    """The full recipe's ring (100,000 rows of 64x64x3 uint8 and 18 actions)
    is about 1.2 GiB with its working set, under the 4 GiB default."""
    keys = dreamer_ring_keys({"rgb": {"shape": [64, 64, 3]}}, ["rgb"], [], (18,), with_is_first=True)
    est = estimate_ring_bytes(keys, 100_000, 1, sequence={"seq_len": 64, "batch_size": 16})
    assert 1.19 * 2**30 < est < 1.21 * 2**30
    assert resolve_device_resident(True, keys, 100_000, 1, 4.0, sequence={"seq_len": 64, "batch_size": 16})[0]


# the DreamerV3 ring's keys: a 64x64x3 uint8 frame, 18 f32 actions, 3 f32 scalars
RING_KEYS = {"rgb": ((64, 64, 3), np.uint8), "actions": ((18,), np.float32), "rewards": ((1,), np.float32),
             "terminated": ((1,), np.float32), "is_first": ((1,), np.float32)}
KEY_SETS = {1: ["rgb"], 2: ["actions", "rgb"], 5: list(RING_KEYS)}


def _keys_case(seed, n_keys, S, e, off, drop, wrap):
    """A ring of ``n_keys`` keys sharing one row table (JAX's
    ``ring_append_rows``), and their staged blocks."""
    rng = np.random.default_rng(seed)
    base, _, row, pos = _case(seed, S, e, (1,), np.float32, off, drop, wrap)
    del base
    rings, staged = {}, {}
    for k in KEY_SETS[n_keys]:
        feat, dtype = RING_KEYS[k]
        if dtype == np.uint8:
            rings[k] = rng.integers(0, 256, (C, e + off) + feat).astype(np.uint8)
            staged[k] = rng.integers(0, 256, (S, e) + feat).astype(np.uint8)
        else:
            rings[k] = rng.normal(size=(C, e + off) + feat).astype(np.float32)
            staged[k] = rng.normal(size=(S, e) + feat).astype(np.float32)
    return rings, staged, row, pos


@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("n_keys", [1, 2, 5])
@pytest.mark.parametrize("S, e, drop, wrap", [(1, 1, "none", True), (2, 4, "ragged", False), (2, 4, "column", True)],
                         ids=["1row-1env-wrap", "2rows-4envs-ragged", "2rows-4envs-column-wrap"])
def test_torch_ring_scatter_keys_is_bit_equal_to_jax_per_key(n_keys, off, backend, S, e, drop, wrap):
    rings, staged, row, pos = _keys_case(10 * n_keys + S + e, n_keys, S, e, off, drop, wrap)
    want = {k: np.asarray(JK.ragged_ring_scatter(jnp.asarray(rings[k]), jnp.asarray(staged[k]), jnp.asarray(row),
                                                 jnp.asarray(pos), off, backend=backend)) for k in rings}
    rb = {k: torch.from_numpy(v.copy()) for k, v in rings.items()}
    blocks = {k: torch.from_numpy(v) for k, v in staged.items()}
    out = K.ragged_ring_scatter_keys(rb, blocks, torch.from_numpy(row), torch.from_numpy(pos), off)
    assert list(out) == list(rb) and all(out[k] is rb[k] for k in rb)  # in place, in the caller's order
    for k in rings:
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    # a sequence of keys takes the same path
    seq = K.ragged_ring_scatter_keys([torch.from_numpy(v.copy()) for v in rings.values()],
                                     [blocks[k] for k in rings], torch.from_numpy(row), torch.from_numpy(pos), off)
    for got, k in zip(seq, rings):
        np.testing.assert_array_equal(got.numpy(), want[k], err_msg=k)
    assert K.LAUNCHES["ragged_ring_scatter"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("off", [0, 3])
def test_torch_ring_scatter_keys_gradient_is_the_per_key_plain_one(off, monkeypatch):
    """Through the wrapper's CPU path and through the ``autograd.Function``
    the card runs (its launch swapped for the plain version): the float keys'
    gradients equal the per-key plain scatter's, the uint8 key takes none."""
    rings, staged, row, pos = _keys_case(3, 5, 2, 4, off, "ragged", False)
    rng = np.random.default_rng(4)
    scales = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in rings.items() if v.dtype == np.float32}
    row_t, pos_t = torch.from_numpy(row), torch.from_numpy(pos)

    def grads(scatter):
        leaves = {k: (torch.from_numpy(rings[k]).requires_grad_(k in scales),
                      torch.from_numpy(staged[k]).requires_grad_(k in scales)) for k in rings}
        out = scatter({k: s.clone() for k, (s, _) in leaves.items()},
                      {k: t for k, (_, t) in leaves.items()})
        sum((out[k] * torch.from_numpy(scales[k])).sum() for k in scales).backward()
        return {k: (s.grad, t.grad) for k, (s, t) in leaves.items() if k in scales}

    want = grads(lambda rb, st: {k: K.ragged_ring_scatter_reference(rb[k], st[k], row_t, pos_t, off) for k in rb})
    got = grads(lambda rb, st: K.ragged_ring_scatter_keys(rb, st, row_t, pos_t, off))

    def plain_launch(storages, staged_blocks, row_, col_offset):
        for s, t in zip(storages, staged_blocks):
            K.ragged_ring_scatter_reference(s, t, row_, pos_t, col_offset)

    monkeypatch.setattr(scatter_module, "_launch", plain_launch)
    card_form = grads(lambda rb, st: dict(zip(rb, scatter_module._RaggedRingScatter.apply(
        row_t, off, len(rb), *rb.values(), *(st[k] for k in rb)))))
    for k in scales:
        for a, b, c in zip(got[k], card_form[k], want[k]):
            assert torch.equal(a, c) and torch.equal(b, c), k


def test_torch_ring_scatter_keys_wrapper_checks_raise():
    rings, staged, row, pos = _keys_case(5, 5, 2, 4, 0, "ragged", False)
    rb = {k: torch.from_numpy(v.copy()) for k, v in rings.items()}
    blocks = {k: torch.from_numpy(v) for k, v in staged.items()}
    row_t, pos_t = torch.from_numpy(row), torch.from_numpy(pos)
    with pytest.raises(ValueError, match="does not start with the rows"):
        K.ragged_ring_scatter_keys(rb, blocks, row_t[:1], pos_t)
    many = {f"k{i}": torch.zeros(C, 4, 1) for i in range(9)}
    with pytest.raises(ValueError, match="1 to 8 ring keys"):
        K.ragged_ring_scatter_keys(many, {k: torch.zeros(2, 4, 1) for k in many}, row_t, pos_t)
    with pytest.raises(ValueError, match="1 to 8 ring keys"):
        K.ragged_ring_scatter_keys({}, {}, row_t, pos_t)
    with pytest.raises(ValueError, match="staged blocks for"):
        K.ragged_ring_scatter_keys(list(rb.values()), list(blocks.values())[:4], row_t, pos_t)
    # a key on another device goes to the kernel, which takes CUDA tensors only: no quiet fallback
    elsewhere = dict(rb, actions=torch.zeros(C, 4, 18, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        K.ragged_ring_scatter_keys(elsewhere, blocks, row_t, pos_t)
    assert K.LAUNCHES["ragged_ring_scatter"] == 0
