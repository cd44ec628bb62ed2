"""rslmtoasa_tpu_torch -- the RS-LMTO-ASA real-space electronic-structure
framework in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``rslmtoasa_tpu`` (the JAX package, which stays the
reference).  It mirrors that package's tree and layouts, computes in
float64/complex128 throughout, and never imports JAX.  The device is
explicit everywhere: ``device='cuda'`` without a card raises.
"""

__version__ = "0.1.0"

from .config import JobConfig  # noqa: E402
from .utils.device import resolve_device  # noqa: E402

__all__ = ["JobConfig", "resolve_device", "__version__"]
