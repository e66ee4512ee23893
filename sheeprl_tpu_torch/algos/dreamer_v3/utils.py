"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["prepare_obs"]


def prepare_obs(obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """Batch-shaped ``(num_envs, ...)`` float32 host arrays: pixels stay NHWC
    and are mapped to ``[-0.5, 0.5]``, vectors are flattened per row."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v, dtype=np.float32)
        if k in cnn_keys:
            v = v.reshape(num_envs, *v.shape[-3:]) / 255.0 - 0.5
        else:
            v = v.reshape(num_envs, -1)
        out[k] = v
    return out
