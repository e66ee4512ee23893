"""Hand-written Hopper kernels, one per Pallas kernel of the JAX package.

Every kernel module holds three things: the plain PyTorch version
(``*_reference``, the ground truth, and what runs on CPU tensors), the
wrapper that launches the CUDA kernel on CUDA tensors or raises, and a count
of launches in :data:`LAUNCHES`, so a run can show that its main path went
through the kernel. A wrapper counts through :func:`count_launch`, under a
lock: the Sebulba actors launch ``gae`` from several threads at once, and a
bare ``+=`` on a dict entry can lose an increment between two threads.
Nothing is built at import: see :mod:`._build`.
"""

from __future__ import annotations

import threading
from typing import Dict

#: kernel name -> launches of its CUDA kernel in this process
LAUNCHES: Dict[str, int] = {
    "gru_gates": 0, "two_hot_symlog_loss": 0, "two_hot_symlog_loss_lse": 0, "two_hot_symlog_loss_lse_bwd": 0,
    "two_hot_symexp_decode": 0, "gae": 0, "sumtree_sample": 0, "ragged_ring_scatter": 0,
}


_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of ``name``'s CUDA kernel, counted exactly from any thread."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


from sheeprl_tpu_torch.ops.kernels.gae import gae, gae_factors, gae_factors_reference, gae_reference  # noqa: E402
from sheeprl_tpu_torch.ops.kernels.gru import (  # noqa: E402
    gru_gates,
    gru_gates_ln,
    gru_gates_ln_reference,
    gru_gates_reference,
)
from sheeprl_tpu_torch.ops.kernels.scatter import (  # noqa: E402
    ragged_ring_scatter,
    ragged_ring_scatter_keys,
    ragged_ring_scatter_reference,
)
from sheeprl_tpu_torch.ops.kernels.sumtree import sumtree_sample, sumtree_sample_reference  # noqa: E402
from sheeprl_tpu_torch.ops.kernels.twohot import (  # noqa: E402
    two_hot_mean,
    two_hot_symexp_decode,
    two_hot_symexp_decode_reference,
    two_hot_symlog_loss,
    two_hot_symlog_loss_lse,
    two_hot_symlog_loss_lse_grad_reference,
    two_hot_symlog_loss_lse_reference,
    two_hot_symlog_loss_reference,
)

__all__ = [
    "LAUNCHES",
    "count_launch",
    "reset_launches",
    "gru_gates",
    "gru_gates_reference",
    "gru_gates_ln",
    "gru_gates_ln_reference",
    "two_hot_symlog_loss",
    "two_hot_symlog_loss_reference",
    "two_hot_symlog_loss_lse",
    "two_hot_symlog_loss_lse_reference",
    "two_hot_symlog_loss_lse_grad_reference",
    "two_hot_symexp_decode",
    "two_hot_symexp_decode_reference",
    "two_hot_mean",
    "gae",
    "gae_reference",
    "gae_factors",
    "gae_factors_reference",
    "sumtree_sample",
    "sumtree_sample_reference",
    "ragged_ring_scatter",
    "ragged_ring_scatter_keys",
    "ragged_ring_scatter_reference",
]
