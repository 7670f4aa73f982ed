"""Fused IC iteration (kernel K1): warp -> residual -> IRLS weight ->
normal-equation moments, in one pass over the image.

`fused_iter_moments` returns the [B, K, 8, 8] coordinate moments of one
Gauss-Newton iteration (K = 5 robust, 2 quadratic) at the motion given as
3x3 matrices, from which ops/kernels/normal_eq assembles H and b. CUDA
tensors run csrc/fused_iter.cu, which forms the sampling coordinates itself
and writes no per-pixel intermediate to device memory; CPU tensors take
`fused_iter_moments_ref`, the op chain the kernel replaces (transform_grid,
warp, masked residual, robust weights, channel-reduced moments).
`bind_fused_iter`, the one place that checks K1's operands, makes its
output and launches it, binds the kernel to a level's planes for the
solver loop; `fused_iter_moments` is its one-call form.

`fused_iter_moments_ablate` launches K1's measurement-only ablation
variants (csrc/fused_iter_ablate.cu), which eval/attr_bench.py times.
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

__all__ = ["FusedIterPlan", "plan_fused_iter", "fused_iter_moments", "bind_fused_iter",
           "fused_iter_moments_ref", "fused_iter_moments_ablate", "ablate_variant",
           "ABLATE_KNOBS", "ABLATE_NOT_APPLICABLE", "LAUNCHES", "ABLATE_LAUNCHES"]

# Number of times K1 (`bind_fused_iter`'s kernel) was launched.
LAUNCHES = 0
# Number of times `fused_iter_moments_ablate` launched its CUDA kernel.
ABLATE_LAUNCHES = 0
# Output rows per block of the kernel: it writes one partial per band.
K1_ROWS = 8

# The ablation variants' knobs (the JAX package's `ablate=` names), each the
# bit of its ABL_* constant in csrc/common.cuh, and what it removes.
ABLATE_KNOBS = {
    "nomask": 1,     # the per-tap column clamps
    "nofold": 2,     # the per-tap row clamps (the TPU's top-row clamp fold)
    "cheapwy": 4,    # the Keys y weights (linear weights instead)
    "noepi": 8,      # the epilogue: mask, template, rho', moments
    "epionly": 16,   # the warp (iw = 0)
    "cheapmom": 32,  # the moments' x-power chain
    "norho": 64,     # the loss (rho' = t2 * lambda)
}
_GATHER = ("prices the TPU's {} of 128-lane tap-column gathers; the Hopper "
           "sampler issues one load a tap and has no chunks or lanes to gather")
# The JAX knobs with no meaning on Hopper, and why.
ABLATE_NOT_APPLICABLE = {
    "chunk1": _GATHER.format("3-chunk unroll (cut to 1 chunk)"),
    "chunk2": _GATHER.format("3-chunk unroll (cut to 2 chunks)"),
    "rollgather": _GATHER.format("lane rotates in place"),
}
# The knob sets csrc/fused_iter_ablate.cu instantiates.
_ABLATE_BUILT = {0, *ABLATE_KNOBS.values(),
                 ABLATE_KNOBS["nomask"] | ABLATE_KNOBS["nofold"] | ABLATE_KNOBS["cheapwy"]}


@dataclass(frozen=True)
class FusedIterPlan:
    """Loop-invariant planar operands of the fused iteration.

    i2p: [B, C, H, W] moving image. tplp: [B, P, H, W] packed template
    operands i1, ix, iy (C planes each), then (gxx, gxy, gyy) when robust
    (P = 3C + 3; P = 3C quadratic). gmom: the quadratic path's [B, 3, H, W]
    gradient moments (K4's maps for the hoisted Hessian); None when robust.
    """

    i2p: torch.Tensor
    tplp: torch.Tensor
    gmom: torch.Tensor | None = None


def plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust: bool = True) -> FusedIterPlan:
    """Pack the template operands ([B, H, W, C] images and gradients, [B, H, W]
    gradient moments) into the kernel's planar layout."""
    parts = [i1, ix, iy]
    if robust:
        parts.append(torch.stack([gxx, gxy, gyy], dim=-1))
    tpl = torch.cat(parts, dim=-1)
    return FusedIterPlan(i2p=i2.permute(0, 3, 1, 2).contiguous(),
                         tplp=tpl.permute(0, 3, 1, 2).contiguous(),
                         gmom=None if robust else torch.stack([gxx, gxy, gyy], dim=1))


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


def _check_args(i2p, tplp, robust, height: int, width: int) -> None:
    """Raise unless the packed plan fits the loss and i2p is the frame."""
    c, h, w = i2p.shape[1:]
    npl = tplp.shape[1]
    if robust is RobustLoss.QUADRATIC:
        raise ValueError("pass robust=None for the quadratic path")
    if robust is not None and npl < 3 * c + 3:
        raise ValueError(f"robust path needs P = 3C+3 packed planes, got {npl} (C={c})")
    if npl < 3 * c:
        raise ValueError(f"packed template needs >= 3C planes, got {npl}")
    if (h, w) != (height, width):
        raise ValueError(f"i2p is {h}x{w}, expected {height}x{width}")


def _check_offsets(c: int, npl: int, h: int, w: int, ho: int, wo: int) -> None:
    """Raise unless a pair's planes fit K1's 32-bit offsets: the C planes of
    the H x W frame and the P packed planes of the Ho x Wo grid. A 10980 x
    10980 pair fits at C = 4 (P = 15, 84% of 2^31) and not at C = 5."""
    if max(c * h * w, npl * ho * wo) >= 2 ** 31:
        raise ValueError("a pair's planes are too large for the kernel's 32-bit offsets")


def _k1_operands(i2p, tplp, projective, height, width, robust, nanifoutside, delta,
                 y_offset):
    """Check K1's planes and make its outputs: (partial, out, the scalar
    arguments of its C entry)."""
    b, c, h, w = i2p.shape
    npl, ho, wo = tplp.shape[1:]
    _build.check_operand(i2p, "i2p", (b, c, h, w))
    _build.check_operand(tplp, "tplp", (b, npl, ho, wo))
    _check_offsets(c, npl, h, w, ho, wo)
    nk = 2 if robust is None else 5
    nbands = -(-ho // K1_ROWS)
    partial = torch.empty((b, nk, nbands, 25), dtype=torch.float32, device=i2p.device)
    out = torch.empty((b, nk, 8, 8), dtype=torch.float32, device=i2p.device)
    scalars = (b, c, npl, h, w, ho, wo, int(projective), 0 if robust is None else robust.value,
               int(nanifoutside), int(delta), int(y_offset), 1.0 / float(max(height, width)))
    return partial, out, scalars


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
    moments = bind_fused_iter(FusedIterPlan(i2p, tplp), projective, height, width, robust,
                              nanifoutside, delta, y_offset)
    _build.use_kernel(i2p, tplp, mat)       # raises on matrices on another device
    lam = torch.as_tensor(lam, dtype=torch.float32, device=i2p.device)
    return moments(mat, lam.expand(i2p.shape[0]).contiguous())


def bind_fused_iter(plan: FusedIterPlan, projective: bool, height: int, width: int,
                    robust: RobustLoss | None, nanifoutside: bool, delta: int,
                    y_offset: int = 0):
    """K1 bound to a level's plan for the solver loop (the arguments of
    `fused_iter_moments`): the planes checked and, on CUDA, the kernel's
    output and scratch allocated once. Returns moments(mat, lam) -> [B, K,
    8, 8] for [B, 3, 3] motion matrices and a [B] lambda; on CUDA every call
    launches K1 into the same output tensor, which the next call
    overwrites. On CPU tensors it runs `fused_iter_moments_ref`."""
    i2p, tplp = plan.i2p, plan.tplp
    _check_args(i2p, tplp, robust, height, width)
    if not _build.use_kernel(i2p, tplp):
        def moments_ref(mat, lam):
            lam = torch.as_tensor(lam, dtype=torch.float32, device=i2p.device)
            return fused_iter_moments_ref(i2p, tplp, mat, projective, lam.expand(i2p.shape[0]),
                                          height, width, robust, nanifoutside, delta, y_offset)
        return moments_ref
    b = i2p.shape[0]
    partial, out, scalars = _k1_operands(i2p, tplp, projective, height, width, robust,
                                         nanifoutside, delta, y_offset)

    def moments(mat, lam):
        global LAUNCHES
        _build.check_operand(mat, "mat", (b, 3, 3))
        _build.check_operand(lam, "lam", (b,))
        _build.launch("ica_fused_iter_moments", i2p, tplp, mat, lam, partial, out, *scalars)
        LAUNCHES += 1
        return out
    return moments


def ablate_variant(ablate: str) -> int:
    """The ABL_* bit set of an `ablate` string in the JAX spelling
    ("nomask,chunk2,cheapwy,nofold"; "" for the full kernel). Knobs with no
    Hopper meaning (ABLATE_NOT_APPLICABLE) drop out of a combination and
    raise alone; unknown knobs and sets the library does not instantiate
    raise."""
    knobs = [k.strip() for k in ablate.split(",") if k.strip()]
    unknown = [k for k in knobs if k not in ABLATE_KNOBS and k not in ABLATE_NOT_APPLICABLE]
    if unknown:
        raise ValueError(f"unknown ablation knobs {unknown}")
    kept = [k for k in knobs if k in ABLATE_KNOBS]
    if knobs and not kept:
        raise ValueError(f"{ablate!r} is not applicable on Hopper: "
                         + "; ".join(ABLATE_NOT_APPLICABLE[k] for k in knobs))
    bits = 0
    for k in kept:
        bits |= ABLATE_KNOBS[k]
    if bits not in _ABLATE_BUILT:
        raise ValueError(f"no ablation variant is built for {','.join(kept)!r}")
    return bits


def fused_iter_moments_ablate(i2p, tplp, mat, projective: bool, lam, height: int, width: int,
                              robust: RobustLoss, nanifoutside: bool, delta: int,
                              y_offset: int = 0, *, ablate: str) -> torch.Tensor:
    """K1 with one cost slice removed (`ablate`, see `ablate_variant`), for
    timing only (eval/attr_bench.py): [B, 5, 8, 8], the arguments of
    `fused_iter_moments` for C = 3 on a robust loss.

    The moments are wrong by design, save for "" (the production kernel's
    arithmetic) and "nomask" and "nofold" (equal to it bit for bit at
    delta >= 2, where every counted pixel's taps lie inside the frame).
    The variants have no plain version, so CPU tensors raise, as do any
    other C, the quadratic path and frames under 4x4.
    """
    global ABLATE_LAUNCHES
    variant = ablate_variant(ablate)
    if not _build.use_kernel(i2p, tplp, mat):
        raise ValueError("the ablation variants run only on CUDA tensors: they have no "
                         "plain version")
    if robust is None or robust is RobustLoss.QUADRATIC:
        raise ValueError("the ablation variants are built for the robust path only")
    _check_args(i2p, tplp, robust, height, width)
    if i2p.shape[1] != 3 or min(height, width) < 4:
        raise ValueError(f"the ablation variants are built for C = 3 and frames of at least "
                         f"4x4, got i2p {tuple(i2p.shape)}")
    b = i2p.shape[0]
    partial, out, scalars = _k1_operands(i2p, tplp, projective, height, width, robust,
                                         nanifoutside, delta, y_offset)
    _build.check_operand(mat, "mat", (b, 3, 3))
    lam = torch.as_tensor(lam, dtype=torch.float32, device=i2p.device).expand(b).contiguous()
    _build.launch("ica_fused_iter_ablate", i2p, tplp, mat, lam, partial, out, *scalars, variant)
    ABLATE_LAUNCHES += 1
    return out
