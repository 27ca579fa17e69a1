"""mpmcxx_tpu_torch — the PyTorch/CUDA port of mpmcxx_tpu for one NVIDIA H100.

JAX twin: mpmcxx_tpu/__init__.py.  The package mirrors the JAX package's
layout module for module; each module's docstring names its twin.  It
imports torch and never jax.  Tensors carry explicit devices and dtypes:
float64 where the JAX package is float64, float32 for the SCF planes.
The hand-written Hopper kernels live in ``csrc/`` and are built at first
use (``ops/kernels.py``).
"""

import torch

# The twin's f32 matmuls ask for Precision.HIGHEST (ops/polar_cache.py);
# TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import constants  # noqa: E402
from .flags import FFlags, RunParams  # noqa: E402
from .pbc import PBC  # noqa: E402
from .state import Observables, SystemState, build_state  # noqa: E402

__all__ = ["constants", "FFlags", "RunParams", "PBC", "Observables",
           "SystemState", "build_state"]
