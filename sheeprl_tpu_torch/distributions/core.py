"""Distributions (counterpart of ``sheeprl_tpu/distributions/core.py``): the
one-hot categoricals of the RSSM and the discrete actor, the diagonal
``Normal`` of the continuous PPO-family and DreamerV3 actors, the
tanh-squashed ``TanhNormal`` of the Dreamers' ``tanh_normal`` actors, the
``TruncatedNormal`` of Dreamer V2's ``trunc_normal`` actor, and DreamerV3's
training heads (``TwoHotEncodingDistribution``, ``SymlogDistribution``,
``MSEDistribution``, ``BernoulliSafeMode``), with ``Independent`` and
``kl_divergence``.

Sampling is Gumbel-max, ``argmax(logits + g)``, as ``jax.random.categorical``
draws it. The noise comes from an explicit ``torch.Generator`` or is passed
in as uniforms, so a caller that needs per-row streams (the session step)
hands in its own. ``Normal`` samples ``loc + scale * eps`` from standard
normals drawn the same way or passed in; ``TruncatedNormal`` inverts its CDF
at uniforms drawn or passed in. The two frameworks never give the
same draws for one seed; tests feed both the same noise or compare logits
instead.

Below float32 (``fabric.precision=bf16-mixed``) every distribution lifts its
parameters to float32 first (:func:`_lift`), so log-probs, KLs, entropies
and softmaxes run in float32, and casts its samples, modes and means back to
the parameters' own dtype (``_sample_dtype``), as the JAX package does. With
float32 parameters both are no-ops.

``distribution.validate_args`` (:func:`set_validate_args`, wired from the
run config by the CLI) turns on the JAX package's static argument checks at
the same constructors and with the same messages: broadcastable shapes and
floating dtypes for ``Normal``, at least one dim of ``OneHotCategorical``
logits, broadcastable ``TruncatedNormal`` parameters. They read shapes and
dtypes only, never a value, so nothing is copied back from the card.
``TruncatedNormal`` checks ``low < high`` under either setting.
"""

from __future__ import annotations

import math

from typing import Optional

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.core import symexp, symlog
from sheeprl_tpu_torch.ops.kernels import two_hot_mean, two_hot_symlog_loss_lse

__all__ = [
    "set_validate_args",
    "validate_args",
    "OneHotCategorical",
    "OneHotCategoricalStraightThrough",
    "Normal",
    "TanhNormal",
    "TruncatedNormal",
    "Independent",
    "TwoHotEncodingDistribution",
    "SymlogDistribution",
    "MSEDistribution",
    "BernoulliSafeMode",
    "kl_divergence",
]


_VALIDATE = False


def set_validate_args(enabled: bool) -> None:
    """Turn the static argument checks on or off for the whole process
    (``distribution.validate_args``; JAX ``set_validate_args``)."""
    global _VALIDATE
    _VALIDATE = bool(enabled)


def validate_args() -> bool:
    """Whether the static argument checks are on."""
    return _VALIDATE


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def _dtype_name(x) -> str:
    """A dtype as the JAX package names it (a Python number as JAX's weak type)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    if isinstance(x, bool):
        return "bool"
    return "float32" if isinstance(x, float) else "int32"


def _check_broadcastable(name: str, *arrays) -> None:
    if not _VALIDATE:
        return
    try:
        torch.broadcast_shapes(*(_shape(a) for a in arrays))
    except RuntimeError as e:
        raise ValueError(f"{name}: arguments are not broadcastable: {[_shape(a) for a in arrays]}") from e


def _check_floating(name: str, **arrays) -> None:
    if not _VALIDATE:
        return
    for arg, a in arrays.items():
        floating = a.is_floating_point() if isinstance(a, torch.Tensor) else isinstance(a, float)
        if not floating:
            raise ValueError(f"{name}: '{arg}' must be floating point, got {_dtype_name(a)}")


def _lift(x):
    """A floating tensor below float32 as float32; anything else as is."""
    if isinstance(x, torch.Tensor) and x.is_floating_point() and x.element_size() < 4:
        return x.float()
    return x


class OneHotCategorical:
    """Categorical over the last axis with one-hot values."""

    def __init__(self, logits: torch.Tensor) -> None:
        if _VALIDATE and logits.ndim < 1:
            raise ValueError(f"OneHotCategorical: logits must have at least 1 dim, got {logits.ndim}")
        self._sample_dtype = logits.dtype
        logits = _lift(logits)
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def num_classes(self) -> int:
        return int(self.logits.shape[-1])

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        return F.one_hot(idx, self.num_classes).to(self._sample_dtype)

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
        probs = self.probs.to(self._sample_dtype)
        return hard + probs - probs.detach()

    def sample(self, generator=None, uniform=None) -> torch.Tensor:
        return self.rsample(generator, uniform)


class Normal:
    """Gaussian with elementwise ``loc`` and ``scale`` (a tensor, or a
    number such as Dreamer V2's unit scale); ``log_prob`` and ``entropy`` in
    the JAX package's formulas and op order."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        _check_broadcastable("Normal", loc, scale)
        _check_floating("Normal", loc=loc, scale=scale)
        self._sample_dtype = loc.dtype
        self.loc = _lift(loc)
        self.scale = _lift(scale)

    def _shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def _log_scale(self) -> "torch.Tensor | float":
        return math.log(self.scale) if isinstance(self.scale, (int, float)) else torch.log(self.scale)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - self._log_scale() - 0.5 * math.log(2 * math.pi)

    def entropy(self) -> torch.Tensor:
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale) + torch.zeros_like(self.loc)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc.expand(self._shape()).to(self._sample_dtype)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def _draw(self, generator: Optional[torch.Generator], noise: Optional[torch.Tensor]) -> torch.Tensor:
        shape = tuple(self._shape())
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        elif noise.ndim < len(shape) or tuple(noise.shape[noise.ndim - len(shape):]) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected (..., {shape})")
        return self.loc + self.scale * noise

    def rsample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``loc + scale * noise``; ``noise`` (standard normals of the
        broadcast shape, or ``(n, *shape)`` for ``n`` draws) is drawn from
        ``generator`` when not given."""
        return self._draw(generator, noise).to(self._sample_dtype)

    def sample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(generator, noise).detach()


class TanhNormal:
    """``tanh`` of a :class:`Normal` draw (the JAX package's ``TanhNormal``):
    ``rsample`` squashes ``loc + scale * noise``, ``mode`` and ``mean`` are
    ``tanh(loc)``, and ``log_prob`` carries the log-det-Jacobian of the
    squash. It has no closed-form entropy: :meth:`entropy` raises, as the
    JAX one does."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.base = Normal(loc, scale)

    def rsample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the squash takes the float32 draw: in bfloat16, tanh saturates to +-1
        return torch.tanh(self.base._draw(generator, noise)).to(self.base._sample_dtype)

    def sample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(generator, noise).detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        value = torch.clamp(_lift(value), -1 + 1e-6, 1 - 1e-6)
        return self.base.log_prob(torch.atanh(value)) - torch.log1p(-(value**2) + 1e-6)

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError("a tanh-squashed Normal has no closed-form entropy")

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(_lift(self.base.mean)).to(self.base._sample_dtype)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(_lift(self.base.mode)).to(self.base._sample_dtype)


_SQRT2 = math.sqrt(2.0)


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF, ``0.5 (1 + erf(x / sqrt 2))``."""
    return 0.5 * (1 + torch.erf(x / _SQRT2))


def _phi(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x**2) / math.sqrt(2 * math.pi)


class TruncatedNormal:
    """``Normal(loc, scale)`` truncated to ``[low, high]`` (the JAX
    package's ``TruncatedNormal``). ``rsample`` inverts the CDF at a uniform
    ``u``: ``loc + scale * ndtri(clip(Phi(alpha) + u Z, 1e-7, 1 - 1e-7))``,
    clipped to ``[low + eps, high - eps]``, differentiable in ``loc`` and
    ``scale``; ``Z = max(Phi(beta) - Phi(alpha), 1e-8)``. ``log_prob`` is
    ``-inf`` outside the bounds."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: float = -1.0, high: float = 1.0,
                 eps: float = 1e-6) -> None:
        _check_broadcastable("TruncatedNormal", loc, scale)
        if not float(low) < float(high):
            raise ValueError(f"TruncatedNormal: low ({low}) must be < high ({high})")
        self._sample_dtype = loc.dtype
        loc, scale = _lift(loc), _lift(scale)
        self.loc, self.scale = loc, scale
        self.low, self.high, self.eps = float(low), float(high), float(eps)
        self._alpha = (self.low - loc) / scale
        self._beta = (self.high - loc) / scale
        self._phi_alpha = _ndtr(self._alpha)
        self._phi_beta = _ndtr(self._beta)
        self._Z = torch.clamp(self._phi_beta - self._phi_alpha, min=1e-8)
        self._log_Z = torch.log(self._Z)

    def _shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def rsample(self, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One draw per element, or with ``uniform`` of shape ``(n, *batch)``
        ``n`` draws; ``uniform`` (values in [0, 1)) is drawn from
        ``generator`` when not given."""
        shape = tuple(self._shape())
        if uniform is None:
            uniform = torch.rand(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        elif uniform.ndim < len(shape) or tuple(uniform.shape[uniform.ndim - len(shape):]) != shape:
            raise ValueError(f"uniform noise has shape {tuple(uniform.shape)}, expected (..., {shape})")
        p = self._phi_alpha + uniform * self._Z
        x = self.loc + self.scale * torch.special.ndtri(torch.clamp(p, 1e-7, 1 - 1e-7))
        return torch.clamp(x, self.low + self.eps, self.high - self.eps).to(self._sample_dtype)

    def sample(self, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rsample(generator, uniform).detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        log_unnorm = -0.5 * z**2 - 0.5 * math.log(2 * math.pi) - torch.log(self.scale)
        inside = (value >= self.low) & (value <= self.high)
        return torch.where(inside, log_unnorm - self._log_Z, torch.full_like(log_unnorm, -math.inf))

    def entropy(self) -> torch.Tensor:
        """``log(sqrt(2 pi e) scale Z) + (alpha phi(alpha) - beta phi(beta)) / (2 Z)``."""
        a, b = self._alpha, self._beta
        return (0.5 * math.log(2 * math.pi * math.e) + torch.log(self.scale) + self._log_Z
                + (a * _phi(a) - b * _phi(b)) / (2 * self._Z))

    @property
    def mean(self) -> torch.Tensor:
        return (self.loc + self.scale * (_phi(self._alpha) - _phi(self._beta)) / self._Z).to(self._sample_dtype)

    @property
    def mode(self) -> torch.Tensor:
        return torch.clamp(self.loc, self.low, self.high).to(self._sample_dtype)


class Independent:
    """Sums log-probs and entropies over the rightmost ``ndims`` dims."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1) -> None:
        self.base = base
        self.ndims = int(reinterpreted_batch_ndims)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.ndims == 0 else torch.sum(x, dim=tuple(range(-self.ndims, 0)))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(value))

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    def sample(self, *args, **kwargs) -> torch.Tensor:
        return self.base.sample(*args, **kwargs)

    def rsample(self, *args, **kwargs) -> torch.Tensor:
        return self.base.rsample(*args, **kwargs)


class _DistanceHead:
    """Decoder output scored by a negative squared distance, summed over the
    rightmost ``dims`` dims."""

    def __init__(self, mode: torch.Tensor, dims: int) -> None:
        self._mode = mode
        self.dims = int(dims)

    def _aggregate(self, distance: torch.Tensor) -> torch.Tensor:
        return torch.sum(distance, dim=tuple(range(-self.dims, 0)))


class SymlogDistribution(_DistanceHead):
    """Log-prob is the negative squared error in symlog space."""

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._aggregate(-((self._mode - symlog(value)) ** 2))

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)


class MSEDistribution(_DistanceHead):
    """Log-prob is the negative squared error."""

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._aggregate(-((self._mode - value) ** 2))

    @property
    def mode(self) -> torch.Tensor:
        return self._mode


class TwoHotEncodingDistribution:
    """Two-hot categorical over ``linspace(-20, 20, K)`` in symlog space with
    one event dim, the JAX package's default transforms (the only ones
    DreamerV3 uses). It keeps the head's raw logits: ``log_prob`` is the
    two-hot loss with the log-normalisation fused in and ``mean`` the decode
    (the CUDA kernels on the card, as the JAX package's are there; on the
    CPU the JAX package's ops, the normalisation first)."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.raw_logits = _lift(logits)  # the two-hot kernels take float32 logits
        self._logits: Optional[torch.Tensor] = None

    @property
    def logits(self) -> torch.Tensor:
        """The log-normalised logits, computed at first read."""
        if self._logits is None:
            self._logits = self.raw_logits - torch.logsumexp(self.raw_logits, dim=-1, keepdim=True)
        return self._logits

    @property
    def mean(self) -> torch.Tensor:
        return two_hot_mean(self.raw_logits)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return two_hot_symlog_loss_lse(self.raw_logits, value)


class BernoulliSafeMode:
    """Bernoulli over logits whose mode is 0 at p == 0.5."""

    def __init__(self, logits: torch.Tensor) -> None:
        self._sample_dtype = logits.dtype
        self.logits = _lift(logits)

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        lg = self.logits
        return -(torch.clamp(lg, min=0) - lg * value + torch.log1p(torch.exp(-torch.abs(lg))))

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -(p * torch.log(p + 1e-8) + (1 - p) * torch.log(1 - p + 1e-8))

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self._sample_dtype)


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p || q) for ``Independent`` pairs of one-hot categoricals or of
    Normals, in the JAX package's formulas."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        if p.ndims != q.ndims:
            raise ValueError("Independent KL requires matching event ndims")
        return p._reduce(kl_divergence(p.base, q.base))
    if isinstance(p, OneHotCategorical) and isinstance(q, OneHotCategorical):
        return torch.sum(p.probs * (p.logits - q.logits), dim=-1)
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    raise NotImplementedError(f"KL not implemented for {type(p).__name__} || {type(q).__name__}")
