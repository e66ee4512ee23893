"""The Dreamer sequence ring's storage spec and allocation (counterpart of
``dreamer_ring_keys`` and ``init_device_ring`` in
``sheeprl_tpu/utils/burst.py``). The hybrid host player and its burst
runner wait for a later slice."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.ring import torch_dtype

__all__ = ["dreamer_ring_keys", "init_device_ring"]


def dreamer_ring_keys(
    observation_space: Mapping[str, Any], cnn_keys, mlp_keys, actions_dim, with_is_first: bool
) -> Dict[str, Tuple[tuple, Any]]:
    """Ring storage spec for a Dreamer family, in the JAX package's key
    order: pixel keys stay uint8 on the card, vectors, actions, rewards and
    ``terminated`` are float32; ``is_first`` only for the families whose
    dynamic rollout reads it (V2/V3). ``observation_space`` is the run
    config's ``spaces.obs`` block (``{key: {"shape": [...]}}``)."""
    specs: Dict[str, Tuple[tuple, Any]] = {}
    for k in cnn_keys:
        specs[k] = (tuple(int(s) for s in observation_space[k]["shape"]), np.dtype(np.uint8))
    for k in mlp_keys:
        specs[k] = (tuple(int(s) for s in observation_space[k]["shape"]), np.dtype(np.float32))
    specs["actions"] = ((int(np.sum(actions_dim)),), np.dtype(np.float32))
    specs["rewards"] = ((1,), np.dtype(np.float32))
    specs["terminated"] = ((1,), np.dtype(np.float32))
    if with_is_first:
        specs["is_first"] = ((1,), np.dtype(np.float32))
    return specs


def init_device_ring(ring_keys: Dict[str, Tuple[tuple, Any]], capacity: int, n_envs: int, device, rb=None):
    """Allocate the ring ``{key: (capacity, n_envs, *shape)}`` on ``device``,
    zeroed where it is made (never built on the host and copied over), or,
    given per-env host buffers ``rb`` (an ``EnvIndependentReplayBuffer``
    restored from a checkpoint), filled from them: each key is assembled on
    the host and copied in one transfer. Returns ``(rb_dev, pos, valid)``,
    the heads as host int64 arrays."""
    dev_pos = np.zeros(n_envs, np.int64)
    dev_valid = np.zeros(n_envs, np.int64)
    rb_dev = {}
    for k, (shape, dtype) in ring_keys.items():
        if rb is None:
            rb_dev[k] = torch.zeros((capacity, n_envs) + tuple(shape), dtype=torch_dtype(dtype), device=device)
            continue
        host = np.zeros((capacity, n_envs) + tuple(shape), np.dtype(dtype))
        for e, sub in enumerate(rb.buffer):
            if k in sub.buffer:
                host[:, e] = np.asarray(sub.buffer[k][:, 0], dtype=host.dtype)
        rb_dev[k] = torch.from_numpy(host).to(device)
    if rb is not None:
        for e, sub in enumerate(rb.buffer):
            dev_pos[e] = sub.pos
            dev_valid[e] = capacity if sub.full else sub.pos
    return rb_dev, dev_pos, dev_valid
