"""Numerical hygiene helpers (reference: src/utils.py:3-18)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["valid_values"]


def valid_values(array) -> bool:
    """True iff the array (numpy or a tensor on any device) contains no NaN
    or Inf (host-side check)."""
    if isinstance(array, torch.Tensor):
        return bool(torch.isfinite(array).all())
    return bool(np.isfinite(np.asarray(array)).all())
