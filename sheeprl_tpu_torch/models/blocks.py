"""Network blocks (counterpart of ``sheeprl_tpu/models/blocks.py``).

Submodules keep the flax names (``dense_0``, ``ln_0``, ``out``, ``conv_0``,
``fc``, ``fused``, ``ln``) so a converted flax parameter tree maps onto
``state_dict`` keys one to one (:mod:`sheeprl_tpu_torch.utils.convert`).
Images are NHWC at every block's interface, as in the JAX package; the
convolutions run NCHW inside.

Every layer holds a compute dtype (``dtype``), as a flax module takes
``dtype=``: float32, the default, runs the plain ``torch.nn`` layer; a lower
one computes as flax does (:class:`Dense`, :class:`Conv2d`,
:class:`ConvTranspose2d`, :class:`LayerNorm`). The parameters stay float32
either way. A family's ``build_agent`` sets the dtype of ``fabric.precision`` on
every layer of its agent with :func:`set_compute_dtype`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.core import layer_norm
from sheeprl_tpu_torch.ops.kernels import gru_gates, gru_gates_ln

__all__ = [
    "get_activation", "lecun_normal_", "Dense", "Conv2d", "ConvTranspose2d", "LayerNorm", "layer_norm",
    "set_compute_dtype", "MLP", "CNN", "NatureCNN", "MultiEncoder", "LayerNormGRUCell", "ConvTranspose",
]

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


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default ``Dense``/``Conv`` initialisation of every
    ``nn.Linear`` and ``nn.Conv2d`` in ``module``: kernels from a normal
    truncated at 2 std with variance ``1 / fan_in``, biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight.shape[1] * int(np.prod(m.weight.shape[2:]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class Dense(nn.Linear):
    """``nn.Linear`` with a compute dtype. Below float32 it computes as
    flax's ``Dense(dtype=...)``: input and weight cast to ``dtype``, the
    product rounded to ``dtype``, then the bias added in ``dtype``."""

    dtype: torch.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype, as :class:`Dense` (flax's
    ``Conv(dtype=...)``: the convolution rounded, then the bias added)."""

    dtype: torch.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), None)
        return y if self.bias is None else y + self.bias.to(self.dtype).view(-1, 1, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with a compute dtype, as :class:`Conv2d`."""

    dtype: torch.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), None, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation,
        )
        return y if self.bias is None else y + self.bias.to(self.dtype).view(-1, 1, 1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with a compute dtype; below float32 :func:`layer_norm`."""

    dtype: torch.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``dtype`` as the compute dtype of every module under ``module``
    whose class declares one (a ``dtype`` class attribute: the layers above,
    and the families' modules that compute on their own parameters);
    returns ``module``."""
    for m in module.modules():
        if isinstance(getattr(type(m), "dtype", None), torch.dtype):
            m.dtype = dtype
    return module


class MLP(nn.Module):
    """``Linear (with bias) -> [LayerNorm(eps 1e-3)] -> activation`` per
    hidden layer, then, with ``output_dim``, a last ``Linear`` named ``out``
    with no activation. ``output_features`` is the width it returns."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int],
        activation: Optional[str] = "relu",
        layer_norm: bool = False,
        output_dim: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.hidden_sizes = tuple(int(s) for s in hidden_sizes)
        self._act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        last = int(input_dim)
        for i, size in enumerate(self.hidden_sizes):
            self.add_module(f"dense_{i}", Dense(last, size))
            if self.layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(size, eps=1e-3))
            last = size
        self.out = Dense(last, int(output_dim)) if output_dim is not None else None
        self.output_features = int(output_dim) if output_dim is not None else last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = self._act(x)
        return x if self.out is None else self.out(x)


def _pair(v: Any) -> tuple:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x) for x in v)


class CNN(nn.Module):
    """Convolutions, each with ``kernel_size``/``stride``/``padding``/``bias``
    from its ``layer_args`` (defaults 3, 1, 0, with bias), then
    ``[LayerNorm over channels] -> activation``. NHWC in and out."""

    def __init__(
        self,
        input_channels: int,
        hidden_channels: Sequence[int],
        layer_args: Union[Mapping[str, Any], Sequence[Mapping[str, Any]], None] = None,
        activation: Optional[str] = "relu",
        layer_norm: bool = False,
        norm_eps: float = 1e-3,
    ) -> None:
        super().__init__()
        self.hidden_channels = tuple(int(c) for c in hidden_channels)
        n = len(self.hidden_channels)
        args = list(layer_args) if isinstance(layer_args, (list, tuple)) else [layer_args] * n
        self._act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        last = int(input_channels)
        for i, ch in enumerate(self.hidden_channels):
            kw: Dict[str, Any] = dict(args[i] or {})
            conv = Conv2d(
                last, ch, _pair(kw.get("kernel_size", 3)), stride=_pair(kw.get("stride", 1)),
                padding=_pair(kw.get("padding", 0)), bias=bool(kw.get("bias", True)),
            )
            self.add_module(f"conv_{i}", conv)
            if self.layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(ch, eps=norm_eps))
            last = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(len(self.hidden_channels)):
            x = getattr(self, f"conv_{i}")(x).permute(0, 2, 3, 1)  # NHWC for the norm and the output
            if self.layer_norm:
                x = getattr(self, f"ln_{i}")(x)
            x = self._act(x)
            if i + 1 < len(self.hidden_channels):
                x = x.permute(0, 3, 1, 2)
        return x


class NatureCNN(nn.Module):
    """The DQN Nature network: convolutions 8/4, 4/2 and 3/1 with 32, 64 and
    64 channels and ReLU (``cnn``), flattened in (H, W, C) order as flax
    flattens NHWC, then ``fc`` and ReLU. NHWC ``(..., H, W, C)`` in."""

    def __init__(self, input_channels: int, screen_size: int, features_dim: int = 512) -> None:
        super().__init__()
        self.cnn = CNN(
            input_channels,
            (32, 64, 64),
            [{"kernel_size": 8, "stride": 4}, {"kernel_size": 4, "stride": 2}, {"kernel_size": 3, "stride": 1}],
        )
        side = int(screen_size)
        for kernel, stride in ((8, 4), (4, 2), (3, 1)):
            side = (side - kernel) // stride + 1
        if side < 1:
            raise ValueError(f"NatureCNN needs a larger screen than {screen_size}")
        self.fc = Dense(side * side * 64, int(features_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = self.cnn(x.reshape(-1, *x.shape[-3:]))
        return F.relu(self.fc(x.reshape(*lead, -1)))


class MultiEncoder(nn.Module):
    """A CNN encoder over the pixel keys and an MLP encoder over the vector
    keys, each taking the observation dict; their features concatenated
    (CNN first). ``output_features`` is the total width."""

    def __init__(self, cnn_encoder: Optional[nn.Module] = None, mlp_encoder: Optional[nn.Module] = None) -> None:
        super().__init__()
        if cnn_encoder is None and mlp_encoder is None:
            raise ValueError("There must be at least one encoder")
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder
        self.output_features = sum(int(e.output_features) for e in (cnn_encoder, mlp_encoder) if e is not None)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [e(obs) for e in (self.cnn_encoder, self.mlp_encoder) if e is not None]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class LayerNormGRUCell(nn.Module):
    """Hafner's GRU cell: one fused ``Linear([h, x]) -> 3H`` projection,
    optional LayerNorm on it, then the gate chain. ``(h, x) -> h``.

    With the LayerNorm, the norm and the gates are :func:`gru_gates_ln`: one
    CUDA kernel on the card, ``F.layer_norm`` and the plain gate chain on
    the CPU (the ops ``self.ln`` and :func:`gru_gates` run there). Without
    it, :func:`gru_gates`. ``self.ln`` stays a LayerNorm that holds the
    float32 affine, so the state-dict keys are those of an unfused cell.
    Below float32 the projection and the carry are in the compute dtype and
    the kernel takes the float32 affine, as flax's ``LayerNorm(dtype=...)``
    and the Pallas kernel compute."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        use_bias: bool = True,
        layer_norm: bool = False,
    ) -> None:
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.fused = Dense(self.hidden_size + int(input_size), 3 * self.hidden_size, bias=use_bias)
        self.ln = LayerNorm(3 * self.hidden_size, eps=1e-3) if layer_norm else None

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        fused = self.fused(torch.cat([h, x], dim=-1)).contiguous()
        if self.ln is None:
            return gru_gates(fused, h.contiguous())
        return gru_gates_ln(fused, h.contiguous(), self.ln.weight, self.ln.bias, self.ln.eps)


class ConvTranspose(nn.Module):
    """Transposed convolution with the JAX package's geometry (its
    ``_ConvTranspose``): flax's VALID transposed convolution, then
    ``padding`` trimmed from both sides of each spatial axis, which is
    ``nn.ConvTranspose2d`` with the same kernel, stride and padding; then
    ``output_padding`` rows and columns of ZEROS at the end of each spatial
    axis, as the JAX layer pads them (``nn.ConvTranspose2d``'s own
    ``output_padding`` would compute those rows and put the bias there).
    NCHW in and out; the layer sits under the flax name ``ConvTranspose_0``.

    Flax applies its HWIO kernel to the dilated input unflipped, torch's
    ``(in, out, kh, kw)`` weight is applied flipped: a flax kernel carries
    over as ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``
    (:mod:`sheeprl_tpu_torch.utils.convert`)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int = 0, bias: bool = True,
        output_padding: int = 0,
    ) -> None:
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(
            int(in_channels), int(out_channels), int(kernel_size), stride=int(stride), padding=int(padding), bias=bias
        )
        self.output_padding = int(output_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(x)
        if self.output_padding:
            x = F.pad(x, (0, self.output_padding, 0, self.output_padding))
        return x
