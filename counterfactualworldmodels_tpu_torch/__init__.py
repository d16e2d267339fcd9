"""counterfactualworldmodels_tpu_torch: the PyTorch/CUDA port of
counterfactualworldmodels_tpu for NVIDIA Hopper (H100).

Module paths and public names mirror the JAX package, so each function has
its counterpart at the same path there. The Pallas kernels of the JAX
package are hand-written CUDA kernels here (``csrc/``, built and bound by
``kernels``); every kernel wrapper runs its plain PyTorch version when
given CPU tensors, which is what the parity tests compare against JAX.

Entry points run on the GPU unless the caller passes ``device='cpu'``.
"""

__version__ = '0.1.0'

from . import (data, kernels, masking, models, ops, pipelines,  # noqa: F401
               training, utils)
from ._device import resolve_device  # noqa: F401
