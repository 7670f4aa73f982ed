"""The warp's floor (kernel K5): a bicubic warp with static indices.

The benchmark's yardstick for the fused iteration (eval/benchmarks.py
`vpu_floor`): the warp's data movement and interpolation arithmetic with
no coordinate math, predicates or clipping. `warp_floor` runs
csrc/warp_floor.cu on CUDA tensors and `warp_floor_ref` on CPU tensors.
The kernel stages each output tile's input box in shared memory by TMA
where the frame allows it (`uses_tma`), else by plain loads.
"""

from __future__ import annotations

import torch

from . import _build
from .warp import warp_planar_ref

__all__ = ["floor_grid", "uses_tma", "warp_floor", "warp_floor_ref", "LAUNCHES"]

# Number of times `warp_floor` launched its CUDA kernel.
LAUNCHES = 0


def floor_grid(b: int, ho: int, wo: int, device=None):
    """The static sampling grid of the floor, (gx, gy) [b, ho, wo]:
    gx = x + 1 + (x mod 32)/32, gy = y + 1 + (y mod 8)/8, so the taps of
    output (y, x) are rows y..y+3 and columns x..x+3 of the source."""
    x = torch.arange(wo, device=device)
    y = torch.arange(ho, device=device)
    gx = (x + 1).float() + (x % 32).float() / 32.0
    gy = (y + 1).float() + (y % 8).float() / 8.0
    return gx.expand(b, ho, wo), gy[:, None].expand(b, ho, wo)


def warp_floor_ref(img_p: torch.Tensor) -> torch.Tensor:
    """Plain version: K3's plain warp on the static grid, where no tap is
    clipped, so it is the same function."""
    b, _, h, w = img_p.shape
    gx, gy = floor_grid(b, h - 3, w - 3, img_p.device)
    return warp_planar_ref(img_p, gx.to(img_p.dtype), gy.to(img_p.dtype))


def uses_tma(img_p: torch.Tensor) -> bool:
    """Whether the kernel loads img_p [B, C, H, W] by TMA: a tensor map
    needs row strides that are multiples of 16 bytes (W % 4 == 0 in
    float32) and a 16-byte aligned base. Other frames take the kernel's
    plain-load path."""
    return img_p.shape[-1] % 4 == 0 and img_p.data_ptr() % 16 == 0


def warp_floor(img_p: torch.Tensor) -> torch.Tensor:
    """img_p [B, C, H, W] -> [B, C, H-3, W-3]: out[b,c,y,x] =
    sum_{i,j<4} wy_i wx_j img_p[b,c,y+i,x+j], Keys weights at the static
    fractions (x mod 32)/32 and (y mod 8)/8."""
    global LAUNCHES
    b, c, h, w = img_p.shape
    if h < 4 or w < 4:
        raise ValueError(f"the floor needs H, W >= 4, got {h}x{w}")
    if not _build.use_kernel(img_p):
        return warp_floor_ref(img_p)
    _build.check_operand(img_p, "img_p", (b, c, h, w))
    if h * w >= 2 ** 31:
        raise ValueError("a plane is too large for the kernel's 32-bit offsets")
    out = torch.empty((b, c, h - 3, w - 3), dtype=torch.float32, device=img_p.device)
    _build.launch("ica_warp_floor", img_p.data_ptr(), out.data_ptr(), b, c, h, w,
                  int(uses_tma(img_p)))
    LAUNCHES += 1
    return out
