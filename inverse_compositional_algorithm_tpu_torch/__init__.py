"""Batched parametric image registration (inverse compositional algorithm)
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of `inverse_compositional_algorithm_tpu` (JAX/Pallas), which stays
beside it as the reference: the same motion models, robust losses, pyramid
and API, with the same array layouts. The device of the data selects the
path: CUDA tensors run the kernels of `ops/kernels/csrc/` (built with nvcc
at first use), CPU tensors run their plain PyTorch versions. Numpy input
goes to CUDA unless the caller passes `device="cpu"`; without a CUDA device
it raises rather than run on the CPU.

Quick start::

    import torch
    import inverse_compositional_algorithm_tpu_torch as ica

    cfg = ica.AlignConfig(transform=ica.TransformType.HOMOGRAPHY,
                          robust=ica.RobustLoss.CHARBONNIER, nscales=5)
    result = ica.align(I1, I2, cfg)   # I*: [H,W,C] or [B,H,W,C], on CUDA
    p = result.params(cfg)
"""

import torch

# Full float32 in every matrix product and convolution on the accuracy path
# (the pyramid's resample products, the 8x8 moment assembly): TF32 keeps
# about three decimal digits and stalls the solver, the counterpart of the
# JAX package's Precision.HIGHEST. cuDNN defaults to TF32, so both are set.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import AlignConfig, config_from_jax, read_config_file, write_config_file  # noqa: E402
from .constants import LAMBDA_0, LAMBDA_N, LAMBDA_RATIO, MAX_ITER, ZOOM_SIGMA_ZERO  # noqa: E402
from .models.api import AlignResult, align, transform_image, warp  # noqa: E402
from .models.ic import ICState, ic_solve  # noqa: E402
from .models.pyramidal import pyramidal_solve  # noqa: E402
from .ops.normal_equations import RobustLoss  # noqa: E402
from .ops.transforms import (  # noqa: E402
    TransformType,
    compose_inverse,
    invert_params,
    matrix_to_params,
    nparams,
    pad_params,
    params_to_matrix,
    transform_grid,
    zoom_in_params,
)

__version__ = "0.1.0"

__all__ = [
    "AlignConfig",
    "AlignResult",
    "ICState",
    "RobustLoss",
    "TransformType",
    "align",
    "warp",
    "transform_image",
    "ic_solve",
    "pyramidal_solve",
    "compose_inverse",
    "invert_params",
    "params_to_matrix",
    "matrix_to_params",
    "transform_grid",
    "zoom_in_params",
    "pad_params",
    "nparams",
    "read_config_file",
    "write_config_file",
    "config_from_jax",
]
