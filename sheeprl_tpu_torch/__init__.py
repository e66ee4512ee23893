"""PyTorch and CUDA port of sheeprl_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel under ``csrc/``. The port imports
nothing of JAX or of ``sheeprl_tpu``.
"""

__version__ = "0.1.0"
