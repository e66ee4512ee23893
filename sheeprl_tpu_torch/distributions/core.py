"""One-hot categoricals (counterpart of ``sheeprl_tpu/distributions/core.py``,
``OneHotCategorical`` and ``OneHotCategoricalStraightThrough``).

Sampling is Gumbel-max, ``argmax(logits + g)``, as ``jax.random.categorical``
draws it. The noise comes from an explicit ``torch.Generator`` or is passed
in as uniforms, so a caller that needs per-row streams (the session step)
hands in its own. The two frameworks never give the same draws for one
seed; tests feed both the same noise or compare logits instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["OneHotCategorical", "OneHotCategoricalStraightThrough"]


class OneHotCategorical:
    """Categorical over the last axis with one-hot values."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def num_classes(self) -> int:
        return int(self.logits.shape[-1])

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        return F.one_hot(idx, self.num_classes).to(self.logits.dtype)

    @property
    def mode(self) -> torch.Tensor:
        return self._one_hot(torch.argmax(self.logits, dim=-1))

    def sample(self, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A hard one-hot draw. ``uniform`` (shaped like ``logits``, values in
        (0, 1)) supplies the noise; else it is drawn from ``generator``."""
        shape = tuple(self.logits.shape)
        if uniform is None:
            uniform = torch.rand(shape, generator=generator, device=self.logits.device, dtype=self.logits.dtype)
        elif tuple(uniform.shape) != shape:
            raise ValueError(f"uniform noise has shape {tuple(uniform.shape)}, expected {shape}")
        gumbel = -torch.log(-torch.log(uniform))
        return self._one_hot(torch.argmax(self.logits + gumbel, dim=-1)).detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.sum(value * self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        return -torch.sum(self.probs * self.logits, dim=-1)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """Forward draws a hard one-hot; the gradient flows through the probs."""

    def rsample(self, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        hard = super().sample(generator, uniform)
        probs = self.probs
        return hard + probs - probs.detach()

    def sample(self, generator=None, uniform=None) -> torch.Tensor:
        return self.rsample(generator, uniform)
