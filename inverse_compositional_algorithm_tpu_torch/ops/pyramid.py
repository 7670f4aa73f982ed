"""Coarse-to-fine pyramid construction.

Gaussian presmoothing followed by Keys bicubic resampling, with two
smoothing conventions:

  * "ipol"     : sigma = ZOOM_SIGMA_ZERO * sqrt(1/nu^2 - 1), sampling at
                 input_coord = output_coord / nu (reference src/zoom.py:29-60).
  * "antialias": sigma = (1/nu - 1) / 2, sampling at pixel centers, the
                 skimage `rescale` default the reference's numpy pyramid calls
                 (src/inverse_compositional_algorithm.py:333-336).

Level sizes round half up (IPOL C++ `zoom_size`). Blur and resample are
linear and separable, so a level is two products with constant per-axis
matrices built in float64 (`_zoom_axis`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import ZOOM_SIGMA_ZERO
from ..utils.profiling import span

__all__ = ["zoom_size", "pyramid_shapes", "gaussian_blur", "zoom_out", "build_pyramid"]


def zoom_size(nx: int, ny: int, factor: float) -> tuple[int, int]:
    """New (nx, ny) after scaling by `factor` (round half-up, IPOL style)."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_shapes(height: int, width: int, nscales: int, nu: float):
    """[(H, W)] for each pyramid level, finest first."""
    shapes = [(height, width)]
    for _ in range(1, nscales):
        h, w = shapes[-1]
        nxx, nyy = zoom_size(w, h, nu)
        shapes.append((nyy, nxx))
    return shapes


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D normalized Gaussian taps, scipy.ndimage.gaussian_filter's layout
    (radius = int(truncate*sigma + 0.5))."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _symmetric_index(n: int, r: int) -> np.ndarray:
    """Source index of each sample of an axis padded by r on both sides with
    numpy's 'symmetric' (edge-repeating) mirror: ... 1 0 | 0 1 ... n-1 | n-1 ..."""
    idx = np.arange(-r, n + r)
    idx = np.where(idx < 0, -idx - 1, idx)
    return np.where(idx >= n, 2 * n - idx - 1, idx)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W, C] with symmetric (edge-repeat)
    padding, scipy's default 'reflect' boundary mode."""
    if sigma <= 0:
        return image
    k = torch.as_tensor(_gaussian_kernel(sigma), dtype=image.dtype, device=image.device)
    r = (k.shape[0] - 1) // 2
    b, h, w, c = image.shape
    x = image.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    # Mirror-pad by index: the mirror repeats the edge sample, which no
    # torch padding mode does, and a large radius may exceed the image.
    iy = torch.as_tensor(_symmetric_index(h, r), device=image.device)
    ix = torch.as_tensor(_symmetric_index(w, r), device=image.device)
    x = x.index_select(2, iy).index_select(3, ix)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _aa_sigma(nu: float, method: str) -> float:
    if method == "ipol":
        return ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (nu * nu) - 1.0)
    if method == "antialias":
        return max(0.0, (1.0 / nu - 1.0) / 2.0)
    raise ValueError(f"unknown pyramid method {method!r}")


def _resample_matrix(n_in: int, coords: np.ndarray) -> np.ndarray:
    """[n_in, n_out] Keys-bicubic sampling matrix for a 1-D grid, with taps
    clipped to the edges like `bicubic_sample`."""
    coords = np.asarray(coords, np.float64)
    x0 = np.floor(coords).astype(np.int64)
    t = coords - x0
    t2 = t * t
    t3 = t2 * t
    ws = [
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    ]
    s = np.zeros((n_in, coords.shape[0]))
    o = np.arange(coords.shape[0])
    for i, w in enumerate(ws):
        np.add.at(s, (np.clip(x0 + (i - 1), 0, n_in - 1), o), w)
    return s.astype(np.float32)


def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n] dense operator of the 1-D Gaussian blur with symmetric boundary."""
    if sigma <= 0:
        return np.eye(n)
    k = _gaussian_kernel(sigma)
    r = (k.shape[0] - 1) // 2
    g = np.zeros((n, n))
    idx = _symmetric_index(n, r)
    for i in range(n):
        np.add.at(g[i], idx[i : i + 2 * r + 1], k)
    return g


@lru_cache(maxsize=None)
def _zoom_axis(n: int, nu: float, method: str) -> np.ndarray:
    """One axis's fused blur+resample operator M = G(sigma) @ S, [n, n'],
    float64: a level is M_y^T I M_x. Cached per axis length, so a square
    frame builds one (the product is dense: 1.3 TFLOP on the host for
    n = 10980)."""
    o = np.arange(zoom_size(n, n, nu)[0], dtype=np.float64)
    s = o / nu if method == "ipol" else (o + 0.5) / nu - 0.5
    return _blur_matrix(n, _aa_sigma(nu, method)) @ _resample_matrix(n, s).astype(np.float64)


@lru_cache(maxsize=64)
def _zoom_axis_on(n: int, nu: float, method: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """`_zoom_axis` in `dtype` on `device`, made once: a 10980-px axis's
    operator is 0.5 GB of float64 to convert and copy over, twice a call."""
    return torch.as_tensor(_zoom_axis(n, nu, method), dtype=dtype, device=device)


def zoom_out(image: torch.Tensor, nu: float, method: str = "ipol") -> torch.Tensor:
    """Downsample [B, H, W, C] by nu (< 1): presmooth + bicubic resample, as
    two products with the per-axis operators (TF32 is off for them, see the
    package's __init__)."""
    b, h, w, c = image.shape
    m_y = _zoom_axis_on(h, nu, method, image.dtype, image.device)
    m_x = _zoom_axis_on(w, nu, method, image.dtype, image.device)
    tmp = torch.einsum("bhwc,hy->bywc", image, m_y)
    return torch.einsum("bywc,wx->byxc", tmp, m_x)


def build_pyramid(image: torch.Tensor, nscales: int, nu: float,
                  method: str = "ipol") -> list[torch.Tensor]:
    """[B, h_s, w_s, C] per level, level 0 = input resolution; each level is
    downsampled from the previous one (reference
    src/inverse_compositional_algorithm.py:331-338). Each level's
    `zoom_out` runs in an `ica.pyramid.zoom` span, finest first."""
    levels = [image]
    for _ in range(1, nscales):
        with span("ica.pyramid.zoom"):
            levels.append(zoom_out(levels[-1], nu, method))
    return levels
