"""Image gradients and the modified-algorithm boundary band.

Central differences with zero at the one-pixel border, plus the band of
`delta` pixels around the border that the modified inverse compositional
algorithm excludes (reference src/inverse_compositional_algorithm.py:81-93),
returned as an explicit mask.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["central_gradients", "boundary_band_mask"]


def central_gradients(image: torch.Tensor):
    """(ix, iy), each [B, H, W, C]: 0.5*(I[i+1] - I[i-1]) in the interior,
    zero on the first/last row and column
    (reference src/inverse_compositional_algorithm.py:81-82)."""
    ix = 0.5 * (image[:, :, 2:, :] - image[:, :, :-2, :])
    ix = F.pad(ix, (0, 0, 1, 1))
    iy = 0.5 * (image[:, 2:, :, :] - image[:, :-2, :, :])
    iy = F.pad(iy, (0, 0, 0, 0, 1, 1))
    return ix, iy


def boundary_band_mask(height: int, width: int, delta: int, *, y_offset: int = 0,
                       full_height: int | None = None, device=None) -> torch.Tensor:
    """[height, width] float32 mask, 0 in the delta-band near the border.

    `y_offset`/`full_height` build the mask of a row tile with the global
    frame's boundaries.
    """
    fh = full_height if full_height is not None else height
    rows = np.arange(y_offset, y_offset + height)
    cols = np.arange(width)
    rok = (rows >= delta) & (rows < fh - delta)
    cok = (cols >= delta) & (cols < width - delta)
    mask = (rok[:, None] & cok[None, :]).astype(np.float32)
    return torch.from_numpy(mask).to(device)
