"""Bicubic warp of a planar image batch (kernel K3).

`warp_planar` runs csrc/warp_planar.cu on CUDA tensors and its plain
version `warp_planar_ref` (the gather sampler of ops/warp.py) on CPU
tensors. The planar source is [B, C, H, W], contiguous and unpadded: the
kernel reads device memory at any frame size, so the TPU package's column
padding and VMEM resident/stream split have no counterpart here.
"""

from __future__ import annotations

import torch

from ..warp import bicubic_sample, domain_mask
from . import _build

__all__ = ["warp_planar", "warp_planar_ref", "warp_image_fast", "LAUNCHES"]

# Number of times `warp_planar` launched its CUDA kernel.
LAUNCHES = 0


def warp_planar_ref(img_p: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Plain version: bicubic_sample on the channels-last view, returned planar."""
    return bicubic_sample(img_p.permute(0, 2, 3, 1), gx, gy).permute(0, 3, 1, 2)


def warp_planar(img_p: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Warp img_p [B, C, H, W] at coordinates gx, gy [B, Ho, Wo] -> [B, C, Ho, Wo].

    Keys bicubic with clip-to-edge taps, exact for arbitrary coordinates
    (NaN where a coordinate is non-finite).
    """
    global LAUNCHES
    if not _build.use_kernel(img_p, gx, gy):
        return warp_planar_ref(img_p, gx, gy)
    b, c, h, w = img_p.shape
    ho, wo = gx.shape[-2:]
    _build.check_operand(img_p, "img_p", (b, c, h, w))
    _build.check_operand(gx, "gx", (b, ho, wo))
    _build.check_operand(gy, "gy", (b, ho, wo))
    if c * max(h * w, ho * wo) >= 2 ** 31:
        raise ValueError("a pair's planes are too large for the kernel's 32-bit offsets")
    out = torch.empty((b, c, ho, wo), dtype=torch.float32, device=img_p.device)
    _build.launch("ica_warp_planar", img_p.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                  out.data_ptr(), b, c, h, w, ho, wo)
    LAUNCHES += 1
    return out


def warp_image_fast(image: torch.Tensor, img_p: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor, delta: int):
    """`warp_planar` + domain mask, the contract of ops.warp.warp_image.

    image: [B, H, W, C] (shape only); img_p: its planar copy [B, C, H, W].
    Returns (warped [B, H, W, C], valid [B, H, W]).
    """
    _, hh, ww, _ = image.shape
    iw = warp_planar(img_p, gx, gy).permute(0, 2, 3, 1)
    return iw, domain_mask(gx, gy, hh, ww, delta)
