"""Image IO helpers (PIL-backed, imported at first use).

The port's copy of the JAX package's `utils/imageio.py`. Images are
exchanged with the solvers as float arrays in the raw 0..255 range, which
is what the reference and the IPOL C++ operate on. `to_uint8` and
`save_image` also take torch tensors, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_image", "save_image", "to_uint8"]


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Load an image file as [H, W, 3] float in 0..255."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=dtype)
    return arr


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float64)


def to_uint8(img) -> np.ndarray:
    """NaN-zero + min/max normalize to uint8, the reference's save path
    (src/keras-tf/tf_inverse_compositional_algorithm.py:41-47)."""
    arr = _numpy(img)
    arr = np.where(np.isfinite(arr), arr, 0.0)
    lo, hi = arr.min(), arr.max()
    if hi - lo < 1e-12:
        return np.zeros(arr.shape, np.uint8)
    return np.clip((arr - lo) / (hi - lo) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(img, path: str) -> None:
    """Save a (possibly NaN-holed) float image, normalizing to uint8."""
    from PIL import Image

    Image.fromarray(to_uint8(img)).save(path)
