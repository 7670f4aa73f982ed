"""Fused IC iteration (kernel K1): warp -> residual -> IRLS weight ->
normal-equation moments, in one pass over the image.

`fused_iter_moments` returns the [B, K, 8, 8] coordinate moments of one
Gauss-Newton iteration (K = 5 robust, 2 quadratic) at the motion given as
3x3 matrices, from which ops/kernels/normal_eq assembles H and b. CUDA
tensors run csrc/fused_iter.cu, which forms the sampling coordinates itself
and writes no per-pixel intermediate to device memory; CPU tensors take
`fused_iter_moments_ref`, the op chain the kernel replaces (transform_grid,
warp, masked residual, robust weights, channel-reduced moments).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..normal_equations import RobustLoss, residual_moments, robust_weights
from ..transforms import matrix_grid
from ..warp import domain_mask
from . import _build
from .normal_eq import moments_ref
from .warp import warp_planar_ref

__all__ = ["FusedIterPlan", "plan_fused_iter", "fused_iter_moments",
           "fused_iter_moments_ref", "LAUNCHES"]

# Number of times `fused_iter_moments` launched its CUDA kernel.
LAUNCHES = 0
# Output rows per block of the kernel: it writes one partial per band.
K1_ROWS = 8


@dataclass(frozen=True)
class FusedIterPlan:
    """Loop-invariant planar operands of the fused iteration.

    i2p: [B, C, H, W] moving image. tplp: [B, P, H, W] packed template
    operands i1, ix, iy (C planes each), then (gxx, gxy, gyy) when robust
    (P = 3C + 3; P = 3C quadratic).
    """

    i2p: torch.Tensor
    tplp: torch.Tensor


def plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust: bool = True) -> FusedIterPlan:
    """Pack the template operands ([B, H, W, C] images and gradients, [B, H, W]
    gradient moments) into the kernel's planar layout."""
    parts = [i1, ix, iy]
    if robust:
        parts.append(torch.stack([gxx, gxy, gyy], dim=-1))
    tpl = torch.cat(parts, dim=-1)
    return FusedIterPlan(i2p=i2.permute(0, 3, 1, 2).contiguous(),
                         tplp=tpl.permute(0, 3, 1, 2).contiguous())


def _unpack(tplp: torch.Tensor, c: int):
    """[B, P, H, W] packed planes -> (i1, ix, iy) [B, H, W, C] and the
    [B, 3, H, W] gradient moments (empty when P = 3C)."""
    nhwc = tplp.permute(0, 2, 3, 1)
    return nhwc[..., :c], nhwc[..., c:2 * c], nhwc[..., 2 * c:3 * c], tplp[:, 3 * c:3 * c + 3]


def fused_iter_moments_ref(i2p, tplp, mat, projective: bool, lam, height: int, width: int,
                           robust: RobustLoss | None, nanifoutside: bool,
                           delta: int, y_offset: int = 0) -> torch.Tensor:
    """Plain version of `fused_iter_moments`: transform_grid's coordinates
    (`matrix_grid`), then the separate-op chain."""
    c = i2p.shape[1]
    ho, wo = tplp.shape[-2:]
    gx, gy = matrix_grid(mat, projective, ho, wo, y_offset)
    i1, ix, iy, g = _unpack(tplp, c)
    iw = warp_planar_ref(i2p, gx, gy).permute(0, 2, 3, 1)
    valid = domain_mask(gx, gy, height, width, delta)[..., None].to(iw.dtype)
    # The masked residual of models/ic.py, with the mask multiplied in as
    # the kernels do (a NaN sample stays NaN under both forms).
    di = (iw - i1) * valid if nanifoutside else iw * valid - i1
    u, v = residual_moments(ix, iy, di)
    if robust is not None:
        lam = torch.as_tensor(lam, dtype=di.dtype, device=di.device).reshape(-1, 1, 1)
        rho = robust_weights(di, lam, robust)
        maps = torch.stack([rho * g[:, 0], rho * g[:, 1], rho * g[:, 2],
                            rho * u, rho * v], dim=1)
    else:
        maps = torch.stack([u, v], dim=1)
    return moments_ref(maps, 1.0 / float(max(height, width)), y_offset)


def fused_iter_moments(i2p, tplp, mat, projective: bool, lam, height: int, width: int,
                       robust: RobustLoss | None, nanifoutside: bool,
                       delta: int, y_offset: int = 0) -> torch.Tensor:
    """[B, K, 8, 8] weighted coordinate moments of one IC iteration.

    Args:
      i2p: [B, C, H, W] planar moving image (the full frame).
      tplp: [B, P, Ho, Wo] packed template operands (`plan_fused_iter`).
        A robust-packed plan (P = 3C + 3) also serves the quadratic path.
      mat: [B, 3, 3] motion matrices (`params_to_matrix`); pixel (x, y) of
        the grid samples I2 at transform_grid's point for them.
      projective: divide by the third row (HOMOGRAPHY); otherwise the
        third row is not read.
      lam: [B] per-pair robust threshold (ignored when robust is None).
      height, width: the frame's dims (= i2p's).
      robust: the loss, or None for the quadratic path.
      delta: domain margin (already capped per level by the solver).
      y_offset: global row of grid row 0 (the coordinates' and the
        moments' y are global).

    Returns:
      [B, K, 8, 8], K = 5 (rho*gxx, rho*gxy, rho*gyy, rho*u, rho*v) or
      2 (u, v).
    """
    global LAUNCHES
    b, c, h, w = i2p.shape
    npl, ho, wo = tplp.shape[1:]
    if robust is RobustLoss.QUADRATIC:
        raise ValueError("pass robust=None for the quadratic path")
    if robust is not None and npl < 3 * c + 3:
        raise ValueError(f"robust path needs P = 3C+3 packed planes, got {npl} (C={c})")
    if npl < 3 * c:
        raise ValueError(f"packed template needs >= 3C planes, got {npl}")
    if (h, w) != (height, width):
        raise ValueError(f"i2p is {h}x{w}, expected {height}x{width}")
    lam = torch.as_tensor(lam, dtype=torch.float32, device=i2p.device).expand(b)
    if not _build.use_kernel(i2p, tplp, mat):
        return fused_iter_moments_ref(i2p, tplp, mat, projective, lam, height, width, robust,
                                      nanifoutside, delta, y_offset)
    _build.check_operand(i2p, "i2p", (b, c, h, w))
    _build.check_operand(tplp, "tplp", (b, npl, ho, wo))
    _build.check_operand(mat, "mat", (b, 3, 3))
    if max(c * h * w, npl * ho * wo) >= 2 ** 31:
        raise ValueError("a pair's planes are too large for the kernel's 32-bit offsets")
    lam = lam.contiguous()
    nk = 2 if robust is None else 5
    nbands = -(-ho // K1_ROWS)
    partial = torch.empty((b, nk, nbands, 25), dtype=torch.float32, device=i2p.device)
    out = torch.empty((b, nk, 8, 8), dtype=torch.float32, device=i2p.device)
    _build.launch("ica_fused_iter_moments", i2p.data_ptr(), tplp.data_ptr(), mat.data_ptr(),
                  lam.data_ptr(), partial.data_ptr(), out.data_ptr(), b, c, npl, h, w, ho, wo,
                  int(projective), 0 if robust is None else robust.value, int(nanifoutside),
                  int(delta), int(y_offset), 1.0 / float(max(height, width)))
    LAUNCHES += 1
    return out
