"""Sum-tree for prioritized replay (PER, arXiv:1511.05952; counterpart of
``sheeprl_tpu/replay/sumtree.py``).

An array-backed segment tree over ``P = next_pow2(n_leaves)`` leaves, stored
flat as a ``(2P,)`` float32 tensor: node ``i``'s children are ``2i`` and
``2i + 1``, the leaves occupy ``[P, 2P)``, the root sum sits at index 1 and
index 0 is unused (always 0). Everything runs on the tree's device, with no
read back to the host.

:func:`update` writes the leaves in place and rebuilds every internal level
with ``log2(P)`` pairwise sums, one kernel a level, as the JAX package does:
``O(P)`` work, and right when one batch names a leaf twice. Duplicates
resolve last-write-wins deterministically: on the card an ``index_put_``
with repeated indices keeps an unspecified writer, so each leaf's last
occurrence is picked explicitly and the other writes go to the unused node 0
with the value 0. :func:`sample` is the plain proportional descent; the
card runs it fused with :func:`importance_weights` in the CUDA
``sumtree_sample`` kernel (:mod:`sheeprl_tpu_torch.ops.kernels.sumtree`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["leaf_count", "init", "update", "rebuild", "total", "get", "sample", "importance_weights", "U_MAX"]

#: draws are kept strictly inside the root mass, so ``mass == total`` cannot
#: fall off the right edge into a zero-priority padding leaf (the float32
#: rounding of ``1 - 1e-7``, as JAX rounds the weak-typed constant)
U_MAX = float(np.float32(1.0 - 1e-7))


def leaf_count(n: int) -> int:
    """Smallest power of two >= n (the tree's leaf capacity)."""
    if n <= 0:
        raise ValueError(f"sum-tree needs a positive leaf count, got {n}")
    return 1 << (int(n - 1).bit_length())


def init(n: int, device: "torch.device | str" = "cpu") -> torch.Tensor:
    """All-zero tree for ``n`` logical leaves (padding leaves stay zero
    forever, so they are never sampled)."""
    return torch.zeros(2 * leaf_count(n), dtype=torch.float32, device=device)


def rebuild(tree: torch.Tensor) -> torch.Tensor:
    """Recompute every internal node from the leaves, in place."""
    w = tree.shape[0] // 4
    while w >= 1:  # level by level: node i = child 2i + child 2i+1
        torch.add(tree[2 * w : 4 * w : 2], tree[2 * w + 1 : 4 * w : 2], out=tree[w : 2 * w])
        w //= 2
    return tree


def update(tree: torch.Tensor, idx: torch.Tensor, priority: torch.Tensor) -> torch.Tensor:
    """Set ``tree[leaf idx] = priority`` in place (batched; a leaf named
    twice keeps its last value, as numpy's fancy assignment does) and
    rebuild the internal levels. Returns ``tree``."""
    P = tree.shape[0] // 2
    idx = idx.reshape(-1).to(torch.int64)
    priority = priority.reshape(-1).to(tree.dtype)
    order = torch.argsort(idx, stable=True)  # equal leaves keep their write order
    leaves = idx[order]
    last = torch.ones_like(leaves, dtype=torch.bool)
    last[:-1] = leaves[:-1] != leaves[1:]
    target = torch.where(last, leaves + P, torch.zeros_like(leaves))
    tree[target] = torch.where(last, priority[order], torch.zeros_like(priority))
    return rebuild(tree)


def total(tree: torch.Tensor) -> torch.Tensor:
    """Root sum (the sampling normalizer), a 0-d tensor."""
    return tree[1]


def get(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Leaf priorities at ``idx`` (batched)."""
    return tree[tree.shape[0] // 2 + idx.to(torch.int64)]


def sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Proportional leaf draw, int32: ``u in [0, 1)`` (batched) selects the
    leaf whose prefix-sum interval holds ``u * total``. Zero-priority leaves
    have empty intervals and are never selected."""
    P = tree.shape[0] // 2
    mass = torch.minimum(u.to(torch.float32), torch.full_like(u, U_MAX, dtype=torch.float32)) * total(tree)
    idx = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    for _ in range(P.bit_length() - 1):  # log2(P) levels
        left = tree[2 * idx]
        go_right = mass >= left
        mass = torch.where(go_right, mass - left, mass)
        idx = 2 * idx + go_right.to(torch.int64)
    return (idx - P).to(torch.int32)


def importance_weights(tree: torch.Tensor, idx: torch.Tensor, n_valid: float, beta: float) -> torch.Tensor:
    """Unnormalized PER importance-sampling weights
    ``max(n_valid * p_i / total, 1e-12)^(-beta)``, float32, for the drawn
    leaves. ``n_valid`` and ``beta`` are host numbers, rounded to float32 as
    the JAX package's operands are; callers normalize by the batch max."""
    p = get(tree, idx)
    prob = p / torch.clamp(total(tree), min=float(np.float32(1e-12)))
    scaled = torch.full_like(prob, float(np.float32(n_valid))) * prob
    return torch.pow(torch.clamp(scaled, min=float(np.float32(1e-12))), -float(np.float32(beta)))
