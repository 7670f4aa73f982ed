"""Batched bicubic sampling and parametric warping (plain PyTorch).

Keys cubic convolution (a = -0.5) with clip-to-edge (Neumann) taps, the
interpolant of the reference's kernel (src/bicubic_interpolation.py:26-41)
and of the JAX package's `ops/warp.py`. This gather sampler is the CPU path
and the plain version that the CUDA warp kernels are held against.
"""

from __future__ import annotations

import torch

from .transforms import TransformType, transform_grid

__all__ = ["keys_cubic_weights", "bicubic_sample", "domain_mask", "warp_image"]


def keys_cubic_weights(t: torch.Tensor):
    """Four Keys (a=-0.5) weights w_{-1}, w_0, w_1, w_2 for the taps at
    floor-1 .. floor+2 of a fractional offset t in [0, 1), in Horner form."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = -0.5 * t3 + t2 - 0.5 * t
    w_0 = 1.5 * t3 - 2.5 * t2 + 1.0
    w_p1 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w_p2 = 0.5 * t3 - 0.5 * t2
    return w_m1, w_0, w_p1, w_p2


def bicubic_sample(image: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Sample `image` [B, H, W, C] at real coordinates gx, gy [B, h, w].

    Returns [B, h, w, C]. Taps are clipped to the image edges (reference
    `neumann_bc`, src/bicubic_interpolation.py:8-23). Indices are int64;
    a non-finite coordinate gives NaN weights and so a NaN sample, as in the
    JAX sampler.
    """
    b, hh, ww, c = image.shape
    oh, ow = gx.shape[-2:]
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = keys_cubic_weights((gx - x0).to(image.dtype))
    wy = keys_cubic_weights((gy - y0).to(image.dtype))
    # Clamp in float before the integer conversion: huge or non-finite
    # coordinates would otherwise overflow it. The taps are clipped to the
    # image below, so the clamp changes no index.
    x0 = x0.nan_to_num(0.0).clamp(-4, ww + 3).to(torch.int64)
    y0 = y0.nan_to_num(0.0).clamp(-4, hh + 3).to(torch.int64)

    flat = image.reshape(b, hh * ww, c)
    out = torch.zeros((b, oh, ow, c), dtype=image.dtype, device=image.device)
    for j in range(4):
        yj = (y0 + (j - 1)).clamp(0, hh - 1)
        for i in range(4):
            xi = (x0 + (i - 1)).clamp(0, ww - 1)
            idx = (yj * ww + xi).reshape(b, oh * ow, 1).expand(b, oh * ow, c)
            tap = torch.gather(flat, 1, idx).reshape(b, oh, ow, c)
            out = out + tap * (wy[j] * wx[i])[..., None]
    return out


def domain_mask(gx: torch.Tensor, gy: torch.Tensor, height: int, width: int,
                delta: int) -> torch.Tensor:
    """True where the source point lies inside the delta-shrunk image domain
    (reference: src/bicubic_interpolation.py:144)."""
    d = float(delta)
    return (
        (gx >= d)
        & (gx <= (width - 1) - d)
        & (gy >= d)
        & (gy <= (height - 1) - d)
    )


def warp_image(image: torch.Tensor, p: torch.Tensor, ttype: TransformType,
               delta: int = 0):
    """I_w(x) = I(x'(x; p)) for image [B, H, W, C] and params p [B, 8].

    Returns (warped [B, H, W, C], valid [B, H, W] bool).
    """
    _, hh, ww, _ = image.shape
    gx, gy = transform_grid(p, ttype, hh, ww)
    return bicubic_sample(image, gx, gy), domain_mask(gx, gy, hh, ww, delta)
