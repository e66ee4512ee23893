"""The port's sum-tree (``sheeprl_tpu_torch/replay/sumtree.py``) and its
``sumtree_sample`` plain version (``ops/kernels/sumtree.py``) against the
JAX package's, on the CPU.

Inputs are numpy from a seed: leaf priorities with some zero leaves and, past
the logical leaf count, the zero padding of the power-of-two tree; uniforms
that include 0 and values just under 1. What must agree:

- the tree after batched updates, duplicate leaves included (last write
  wins), exactly: both sides write the same float32 leaves and sum the same
  pairs;
- the drawn leaves, exactly, against JAX's ``replay.sumtree.sample`` and
  against its ``sumtree_sample`` kernel run through its Pallas body in
  interpret mode and through its lax reference (``backend="pallas"`` and
  ``"lax"``, as ``tests/test_ops/test_kernels.py`` runs them);
- the importance weights within rtol 1e-6 (``pow`` may differ by an ulp);
- the weights' gradient with respect to the tree against ``jax.grad``
  within 1e-5, through the wrapper's CPU path and through the
  ``autograd.Function`` the card runs (its launch swapped for the plain
  version, since the kernel runs only on the card);
- the CUDA kernel's hop-wise descent, emulated in numpy load for load (k
  levels per hop from the aligned ranges ``[i 2^m, (i+1) 2^m)``, in the
  kernel's shared-memory layout), against JAX's reference: leaves exactly,
  the priority it reads equal to the leaf's, weights within rtol 1e-6. This
  holds the kernel's index arithmetic where there is no card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import kernels as JK
from sheeprl_tpu.replay import sumtree as jst
from sheeprl_tpu_torch.ops import kernels as K
from sheeprl_tpu_torch.replay import sumtree as st

# the module, which the package's ``sumtree_sample`` function shadows as an attribute
kernel_module = importlib.import_module("sheeprl_tpu_torch.ops.kernels.sumtree")
W_TOL = dict(rtol=1e-6, atol=0)


def _priorities(rng, n):
    prios = rng.uniform(0.01, 2.0, size=n).astype(np.float32)
    prios[:: max(2, n // 5)] = 0.0  # zero leaves: never drawn
    return prios


def _uniforms(rng, b):
    u = rng.uniform(size=b).astype(np.float32)
    edges = np.array([0.0, np.nextafter(np.float32(1), np.float32(0)), 1 - 1e-7, 0.5], np.float32)
    u[: min(b, 4)] = edges[: min(b, 4)]
    return u


def _trees(n, seed):
    rng = np.random.default_rng(seed)
    prios = _priorities(rng, n)
    jt = jst.update(jst.init(n), jnp.arange(n), jnp.asarray(prios))
    tt = st.update(st.init(n), torch.arange(n), torch.from_numpy(prios))
    return rng, prios, jt, tt


def test_torch_sumtree_leaf_count_and_init_match_jax():
    for n in (1, 2, 5, 8, 9, 1000, 250_000 * 4):
        assert st.leaf_count(n) == jst.leaf_count(n)
    assert st.leaf_count(1_000_000) == 1 << 20 and st.init(21).shape == (64,)
    with pytest.raises(ValueError):
        st.leaf_count(0)
    assert st.U_MAX == float(np.float32(1.0 - 1e-7))


@pytest.mark.parametrize("n", [1, 4, 13, 64, 1000])
def test_torch_sumtree_updates_match_jax_exactly(n):
    """Batched updates with repeated leaves: the same tree, bit for bit."""
    rng, _, jt, tt = _trees(n, n)
    for _ in range(3):
        idx = rng.integers(0, n, size=2 * n + 3)
        prio = rng.uniform(0.0, 3.0, size=idx.shape).astype(np.float32)
        jt = jst.update(jt, jnp.asarray(idx), jnp.asarray(prio))
        tt = st.update(tt, torch.from_numpy(idx), torch.from_numpy(prio))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert float(tt[0]) == 0.0 and float(st.total(tt)) == float(jst.total(jt))
    idx = rng.integers(0, n, size=7)
    np.testing.assert_array_equal(st.get(tt, torch.from_numpy(idx)).numpy(), np.asarray(jst.get(jt, jnp.asarray(idx))))


def test_torch_sumtree_duplicate_updates_last_wins():
    """The JAX package's own case (``tests/test_replay/test_sumtree.py``),
    and a leaf named many times among others."""
    tree = st.update(st.init(8), torch.tensor([3, 3, 3]), torch.tensor([1.0, 2.0, 7.0]))
    assert float(st.get(tree, torch.tensor([3]))[0]) == 7.0 and float(st.total(tree)) == 7.0
    idx = torch.tensor([5, 1, 5, 2, 5, 1])
    tree = st.update(st.init(8), idx, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))
    np.testing.assert_array_equal(st.get(tree, torch.arange(8)).numpy(), [0, 6, 4, 0, 0, 5, 0, 0])
    for i in range(1, 8):  # every internal node the sum of its children
        assert float(tree[i]) == float(tree[2 * i] + tree[2 * i + 1])


@pytest.mark.parametrize("n, b", [(4, 64), (13, 256), (64, 4096), (1000, 1024), (70_000, 256)])
def test_torch_sumtree_sample_and_weights_match_jax(n, b):
    rng, prios, jt, tt = _trees(n, 100 + n)
    u = _uniforms(rng, b)
    leaf = st.sample(tt, torch.from_numpy(u))
    assert leaf.dtype == torch.int32
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jst.sample(jt, jnp.asarray(u))))
    assert np.all(prios[leaf.numpy()] > 0)  # never a zero leaf, never padding
    w = st.importance_weights(tt, leaf, n, 0.4)
    want = jst.importance_weights(jt, jnp.asarray(leaf.numpy()), jnp.asarray(n, jnp.int32), jnp.float32(0.4))
    np.testing.assert_allclose(w.numpy(), np.asarray(want), **W_TOL)


@pytest.mark.parametrize("backend", ["pallas", "lax"])
@pytest.mark.parametrize("n, b, n_valid, beta", [(40, 17, 40, 0.4), (13, 64, 12, 1.0), (300, 256, 300, 0.55)])
def test_torch_sumtree_sample_kernel_plain_version_matches_jax(backend, n, b, n_valid, beta):
    rng, _, jt, tt = _trees(n, 7 * n)
    u = _uniforms(rng, b)
    want_leaf, want_w = JK.sumtree_sample(jt, jnp.asarray(u), jnp.asarray(n_valid, jnp.int32), jnp.float32(beta),
                                          backend=backend)
    leaf, w = K.sumtree_sample_reference(tt, torch.from_numpy(u), n_valid, beta)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want_leaf))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **W_TOL)
    w_leaf, w_w = K.sumtree_sample(tt, torch.from_numpy(u), n_valid, beta)  # a CPU tensor takes the plain version
    assert torch.equal(w_leaf, leaf) and torch.equal(w_w, w)
    assert K.LAUNCHES["sumtree_sample"] == 0


def test_torch_sumtree_sample_gradient_matches_jax(monkeypatch):
    rng, _, jt, tt = _trees(40, 10)
    u = _uniforms(rng, 9)
    scale = rng.uniform(0.5, 2.0, size=9).astype(np.float32)

    def loss(tree):
        return jnp.sum(JK.sumtree_sample(tree, jnp.asarray(u), jnp.asarray(40, jnp.int32), jnp.float32(0.4),
                                         backend="pallas")[1] * scale)

    want = np.asarray(jax.grad(loss)(jt))

    def grad_of(fn):
        t = tt.clone().requires_grad_(True)
        (fn(t, torch.from_numpy(u), 40, 0.4)[1] * torch.from_numpy(scale)).sum().backward()
        return t.grad.numpy()

    np.testing.assert_allclose(grad_of(K.sumtree_sample), want, atol=1e-5, rtol=1e-5)
    # the autograd.Function the card runs, with the plain forward in place of the launch
    monkeypatch.setattr(kernel_module, "_launch", kernel_module.sumtree_sample_reference)
    np.testing.assert_allclose(grad_of(kernel_module._SumtreeSample.apply), want, atol=1e-5, rtol=1e-5)


def test_torch_sumtree_sample_wrapper_raises_off_the_cpu_without_a_card():
    """A tensor that is not on the CPU goes to the kernel, which takes only
    CUDA tensors: no quiet fallback to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        K.sumtree_sample(torch.zeros(16, device="meta"), torch.zeros(4, device="meta"), 8, 0.4)
    assert K.LAUNCHES["sumtree_sample"] == 0


def _hop_descent(tree: np.ndarray, u: np.ndarray, k: int):
    """``csrc/sumtree.cu``'s descent in numpy, load for load: per hop from
    node ``i``, the warp's slice takes float4 ``q`` from the global floats
    ``(i - 1) 2^m + 4q`` (``m = floor(log2 q) + 2``; the first hop, from the
    root, the floats ``4q``) and slots 2..3 from ``2i``; then ``j`` levels
    are walked in the slice with the plain version's float32 arithmetic, two
    per round trip (slots ``2r``, ``4r`` and ``4r + 2`` read together).
    Slots a hop does not load are NaN, so reading one changes the result."""
    P = tree.shape[0] // 2
    levels = P.bit_length() - 1
    leaves, prios, totals = [], [], []
    for ub in u:
        node, depth = 1, 0
        total = p = tree[1]
        mass = np.float32(0)
        while depth < levels:
            j = min(k, levels - depth)
            n4 = 1 << (j - 1)
            sl = np.full(4 * n4, np.nan, np.float32)
            for q in range(n4):
                if depth == 0:
                    sl[4 * q : 4 * q + 4] = tree[4 * q : 4 * q + 4]
                elif q == 0:
                    sl[2:4] = tree[2 * node : 2 * node + 2]
                else:
                    g = ((node - 1) << (q.bit_length() + 1)) + 4 * q
                    assert g % 4 == 0  # a 16-byte load
                    sl[4 * q : 4 * q + 4] = tree[g : g + 4]
            if depth == 0:
                total = sl[1]
                mass = np.minimum(np.float32(ub), np.float32(st.U_MAX)) * total
            rel, m = 1, 0
            while m < j:  # two levels per shared-memory round trip, the last one alone
                left = sl[2 * rel]
                nxt = (sl[4 * rel], sl[4 * rel + 2]) if m + 1 < j else None
                assert not np.isnan(left) and (nxt is None or not np.isnan(nxt).any())
                right = mass >= left
                if right:
                    mass = np.float32(mass - left)
                rel = 2 * rel + int(right)
                if nxt is not None:
                    left2 = nxt[int(right)]
                    if mass >= left2:
                        mass = np.float32(mass - left2)
                        rel = 2 * rel + 1
                    else:
                        rel = 2 * rel
                m += 2
            p = sl[rel]
            node = ((node - 1) << j) + rel
            depth += j
        leaves.append(node - P)
        prios.append(p)
        totals.append(total)
    return np.array(leaves, np.int32), np.array(prios, np.float32), np.array(totals, np.float32)


@pytest.mark.parametrize("k", [1, 5, 7, 10])
@pytest.mark.parametrize("log_leaves", range(1, 13))
def test_torch_sumtree_kernel_hop_descent_matches_jax(log_leaves, k):
    """Trees of 2^1 to 2^12 leaves built by JAX's ``update`` (zero leaves,
    padding past the filled ones), uniforms with 0 and just under 1, and
    trees shallower than k."""
    P = 1 << log_leaves
    n = P // 2 + 1 if P > 2 else P
    rng, prios, jt, _ = _trees(n, 31 * log_leaves + k)
    u = _uniforms(rng, 48)
    want_leaf, want_w = JK.sumtree_sample(jt, jnp.asarray(u), jnp.asarray(n, jnp.int32), jnp.float32(0.55),
                                          backend="lax")
    tree = np.asarray(jt)
    assert tree.shape == (2 * P,)
    leaf, p, total = _hop_descent(tree, u, k)
    np.testing.assert_array_equal(leaf, np.asarray(want_leaf))
    np.testing.assert_array_equal(p, tree[P + leaf])  # the last hop holds the drawn leaf's priority
    assert np.all(prios[leaf] > 0)
    prob = p / np.maximum(total, np.float32(1e-12))
    w = np.power(np.maximum(np.float32(n) * prob, np.float32(1e-12)), np.float32(-0.55))
    np.testing.assert_allclose(w, np.asarray(want_w), **W_TOL)
