"""magi_v2_tpu_torch — MAGI (MAnifold-constrained Gaussian process
Inference) in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``magi_v2_tpu``, which stays beside it as the
reference. Module names match the JAX package's. The package imports
torch, numpy and scipy only; nothing here imports jax.

Entry point: :class:`magi_v2_tpu_torch.MAGI_v2`. The device is chosen by
the caller through ``MagiConfig(device=...)``.
"""

from magi_v2_tpu_torch.config import MagiConfig
from magi_v2_tpu_torch.api import MAGI_v2

__version__ = "0.1.0"

__all__ = ["MAGI_v2", "MagiConfig", "__version__"]
