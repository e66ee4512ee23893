"""The ``ops`` config block (counterpart of the JAX package's
``ops/kernels/registry.py:configure_from_config``).

The JAX package picks each kernel's implementation from ``ops.backend``
(``auto``, ``pallas`` or ``lax``) and per-kernel overrides
``ops.kernels.<name>``. The port has no backend switch: every kernel runs
its hand-written CUDA kernel on CUDA tensors and its plain PyTorch version
on CPU tensors, or raises. So the block is checked, never applied:

- an unknown backend raises :class:`UnknownOpsBackendError` and an override
  of an unknown kernel :class:`UnknownKernelError`, with the JAX registry's
  texts (the kernel names are the JAX registry's);
- ``auto`` and ``pallas`` keep the port's rule (the kernel on the card);
- ``lax`` raises :class:`OpsBackendNotPortedError`: running the plain
  versions on the card would hide the kernels, so a run that asks for it
  stops instead of quietly running either.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

__all__ = [
    "KERNEL_NAMES",
    "VALID_BACKENDS",
    "UnknownOpsBackendError",
    "UnknownKernelError",
    "OpsBackendNotPortedError",
    "configure_from_config",
]

VALID_BACKENDS: Tuple[str, ...] = ("auto", "pallas", "lax")

#: the JAX registry's kernel names, the keys ``ops.kernels`` takes
KERNEL_NAMES: Tuple[str, ...] = (
    "gae", "gru_gates", "ragged_ring_scatter", "sumtree_sample", "two_hot_symexp_decode", "two_hot_symlog_loss",
)


class UnknownOpsBackendError(ValueError):
    """``ops.backend`` (or a per-kernel override) named a backend the JAX
    registry does not know."""

    def __init__(self, backend: Any, kernel: Optional[str] = None):
        scope = f"kernel '{kernel}'" if kernel else "ops.backend"
        super().__init__(
            f"Unknown ops backend {backend!r} for {scope}; valid backends are {', '.join(VALID_BACKENDS)}."
        )
        self.backend = backend
        self.kernel = kernel


class UnknownKernelError(KeyError):
    """An override named a kernel the JAX registry does not hold."""

    def __init__(self, name: Any):
        super().__init__(f"Unknown kernel '{name}'; registered kernels: {', '.join(KERNEL_NAMES)}.")
        self.name = name


class OpsBackendNotPortedError(ValueError):
    """``lax`` was asked for: the port has no backend switch."""

    def __init__(self, kernel: Optional[str] = None):
        scope = f"ops.kernels.{kernel}=lax" if kernel else "ops.backend=lax"
        super().__init__(
            f"{scope}: the port has no backend switch. Every kernel runs its hand-written CUDA kernel on CUDA "
            "tensors and its plain PyTorch version only on CPU tensors; run on the CPU with "
            "fabric.accelerator=cpu, or keep ops.backend=auto"
        )
        self.kernel = kernel


def _check_backend(value: Any, kernel: Optional[str] = None) -> str:
    if value not in VALID_BACKENDS:
        raise UnknownOpsBackendError(value, kernel)
    if value == "lax":
        raise OpsBackendNotPortedError(kernel)
    return value


def configure_from_config(ops_cfg: Any) -> None:
    """Check a run config's ``ops`` block (``backend`` and ``kernels``) in
    the JAX registry's order: the backend, then each override's kernel name
    and backend. A missing or empty block passes."""
    if not ops_cfg:
        return
    backend = ops_cfg.get("backend")
    if backend is not None:
        _check_backend(str(backend))
    for key, value in dict(ops_cfg.get("kernels") or {}).items():
        if key not in KERNEL_NAMES:
            raise UnknownKernelError(key)
        _check_backend(str(value), kernel=key)
