"""Network blocks (counterpart of ``sheeprl_tpu/models/blocks.py``).

Submodules keep the flax names (``dense_0``, ``ln_0``, ``fused``, ``ln``) so
a converted flax parameter tree maps onto ``state_dict`` keys one to one
(:mod:`sheeprl_tpu_torch.utils.convert`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.kernels import gru_gates

__all__ = ["get_activation", "MLP", "LayerNormGRUCell", "ConvTranspose"]

_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "gelu": F.gelu,
    "sigmoid": torch.sigmoid,
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
}


def get_activation(name: Optional[Union[str, Callable]]) -> Callable:
    """Resolve an activation by name; ``torch.nn.X``-style strings resolve by
    their last component, as in the JAX package."""
    if name is None:
        return lambda x: x
    if callable(name):
        return name
    key = str(name).rsplit(".", 1)[-1].lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


class MLP(nn.Module):
    """``Linear (with bias) -> [LayerNorm(eps 1e-3)] -> activation`` per
    hidden layer."""

    def __init__(
        self, input_dim: int, hidden_sizes: Sequence[int], activation: Optional[str] = "relu", layer_norm: bool = False
    ) -> None:
        super().__init__()
        self.hidden_sizes = tuple(int(s) for s in hidden_sizes)
        self._act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        last = int(input_dim)
        for i, size in enumerate(self.hidden_sizes):
            self.add_module(f"dense_{i}", nn.Linear(last, size))
            if self.layer_norm:
                self.add_module(f"ln_{i}", nn.LayerNorm(size, eps=1e-3))
            last = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = self._act(x)
        return x


class LayerNormGRUCell(nn.Module):
    """Hafner's GRU cell: one fused ``Linear([h, x]) -> 3H`` projection,
    optional LayerNorm on it, then the gate chain :func:`gru_gates` (the
    CUDA kernel on the card). ``(h, x) -> h``."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        use_bias: bool = True,
        layer_norm: bool = False,
    ) -> None:
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.fused = nn.Linear(self.hidden_size + int(input_size), 3 * self.hidden_size, bias=use_bias)
        self.ln = nn.LayerNorm(3 * self.hidden_size, eps=1e-3) if layer_norm else None

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        fused = self.fused(torch.cat([h, x], dim=-1))
        if self.ln is not None:
            fused = self.ln(fused)
        return gru_gates(fused.contiguous(), h.contiguous())


class ConvTranspose(nn.Module):
    """Transposed convolution with the JAX package's geometry (its
    ``_ConvTranspose``): flax's VALID transposed convolution, then
    ``padding`` trimmed from both sides of each spatial axis, which is
    ``nn.ConvTranspose2d`` with the same kernel, stride and padding. NCHW in
    and out; the layer sits under the flax name ``ConvTranspose_0``.

    Flax applies its HWIO kernel to the dilated input unflipped, torch's
    ``(in, out, kh, kw)`` weight is applied flipped: a flax kernel carries
    over as ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``
    (:mod:`sheeprl_tpu_torch.utils.convert`)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int = 0, bias: bool = True
    ) -> None:
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            int(in_channels), int(out_channels), int(kernel_size), stride=int(stride), padding=int(padding), bias=bias
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvTranspose_0(x)
