"""A pyramid level's set-up in one pass (kernel K7): gradients, boundary
band, gradient moments and K1's planar operands.

`pack_level` turns a level's images i1, i2 [B, H, W, C] into the
`FusedIterPlan` that K1 reads every trip. CUDA tensors run
csrc/level_pack.cu, which reads each image once and writes the planes in
their final layout; CPU tensors take `pack_level_ref`, the op chain the
kernel replaces (central_gradients -> band -> grad_moments ->
plan_fused_iter).
"""

from __future__ import annotations

import torch

from ..gradients import boundary_band_mask, central_gradients
from ..normal_equations import grad_moments
from . import _build
from .fused_iter import FusedIterPlan, _check_offsets, plan_fused_iter

__all__ = ["level_gradients", "moment_gap", "pack_level", "pack_level_ref", "LAUNCHES"]

# Number of times `pack_level` launched its CUDA kernel.
LAUNCHES = 0


def level_gradients(i1: torch.Tensor, delta: int, nanifoutside: bool):
    """(ix, iy, (gxx, gxy, gyy)) of a level's template [B, H, W, C]: central
    differences, times the boundary band when nanifoutside and delta > 0,
    and their channel-summed moments (the set-up's op chain; the plain
    solver's operands)."""
    _, hh, ww, _ = i1.shape
    ix, iy = central_gradients(i1)
    if nanifoutside and delta > 0:
        band = boundary_band_mask(hh, ww, delta, device=i1.device).to(i1.dtype)[None, :, :, None]
        ix = ix * band
        iy = iy * band
    return ix, iy, grad_moments(ix, iy)


def pack_level_ref(i1: torch.Tensor, i2: torch.Tensor, delta: int, nanifoutside: bool,
                   robust: bool) -> FusedIterPlan:
    """Plain version of `pack_level`: the level set-up's op chain."""
    ix, iy, g = level_gradients(i1, delta, nanifoutside)
    return plan_fused_iter(i1, i2, ix, iy, *g, robust=robust)


def pack_level(i1: torch.Tensor, i2: torch.Tensor, delta: int, nanifoutside: bool,
               robust: bool) -> FusedIterPlan:
    """K1's plan of a level: tplp [B, P, H, W] (i1, ix, iy, then gxx, gxy,
    gyy when `robust`), i2p [B, C, H, W] and, on the quadratic path, the
    gradient moments gmom [B, 3, H, W] for K4.

    Args:
      i1, i2: [B, H, W, C] template and moving image of the level.
      delta: the boundary band's margin, already capped for the level
        (`models.ic.effective_delta`); the gradients take the band when
        nanifoutside and delta > 0.
      robust: pack the moments into tplp (P = 3C + 3) rather than apart.

    CUDA tensors launch csrc/level_pack.cu (float32, contiguous; one launch,
    or one per 65535 pairs past that); CPU tensors take `pack_level_ref`.
    """
    global LAUNCHES
    if not _build.use_kernel(i1, i2):
        return pack_level_ref(i1, i2, delta, nanifoutside, robust)
    b, h, w, c = i1.shape
    _build.check_operand(i1, "i1", (b, h, w, c))
    _build.check_operand(i2, "i2", (b, h, w, c))
    npl = 3 * c + 3 if robust else 3 * c
    _check_offsets(c, npl, h, w, h, w)
    tplp = torch.empty((b, npl, h, w), dtype=torch.float32, device=i1.device)
    i2p = torch.empty((b, c, h, w), dtype=torch.float32, device=i1.device)
    gmom = None if robust else torch.empty((b, 3, h, w), dtype=torch.float32, device=i1.device)
    _build.launch("ica_level_pack", i1, i2, tplp, i2p, gmom, b, c, h, w, int(robust),
                  int(nanifoutside and delta > 0), int(delta))
    LAUNCHES += 1
    return FusedIterPlan(i2p=i2p, tplp=tplp, gmom=gmom)


def moment_gap(got: FusedIterPlan, ref: FusedIterPlan, chunk: int = 64) -> tuple[float, float]:
    """How far `got`'s gradient moments lie from `ref`'s: (largest difference
    in units of 2^-24 of the sum of the moment's C products' magnitudes,
    largest absolute difference), in float64, `chunk` pairs at a time.

    A float32 sum of C products, in any order, lies within (C - 1) such
    units of the exact sum, so two orders lie within 2(C - 1) of each other:
    K7 sums the channels in order, ATen's `.sum(-1)` in its own."""
    c = ref.i2p.shape[1]
    gm, gm_ref = ((got.tplp[:, 3 * c:], ref.tplp[:, 3 * c:]) if ref.gmom is None
                  else (got.gmom, ref.gmom))
    units = err = 0.0
    for b0 in range(0, ref.i2p.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        for k, (m, n) in enumerate([(1, 1), (1, 2), (2, 2)]):
            u, v = (ref.tplp[sl, j * c:(j + 1) * c].double() for j in (m, n))
            mag = (u * v).abs().sum(1)
            diff = (gm[sl, k].double() - gm_ref[sl, k].double()).abs()
            units = max(units, float((diff / (2.0 ** -24 * mag).clamp(min=1e-300)).max()))
            err = max(err, float(diff.max()))
    return units, err
