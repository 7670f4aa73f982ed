"""Bytes and flops the kernels' work needs, counted from the inputs and
outputs whatever implements it (float32 planes, each input read once and
each output written once)."""

from __future__ import annotations


def warp_flops_per_pixel(c: int) -> int:
    """A bicubic sample: Keys weights of both axes (2 x 19), their 16
    products, and 16 multiply-adds per channel."""
    return 2 * 19 + 16 + 32 * c


def moments_flops_per_pixel(k: int) -> int:
    """The moment epilogue: x/L and its powers (5), and a multiply-add per
    map and power (10 per map)."""
    return 5 + 10 * k


def fused_iter_flops_per_pixel(c: int, robust: bool) -> int:
    """One solver trip at a pixel: the sampling point (a homography's three
    rows and two divides, 14), the warp, the masked residual and its channel
    sums (8 per channel), rho' and the weighted maps (7, robust) and the
    moments (K = 5 robust, 2 quadratic)."""
    return (14 + warp_flops_per_pixel(c) + 8 * c + (7 if robust else 0)
            + moments_flops_per_pixel(5 if robust else 2))


def fused_iter_bytes(c: int, h: int, w: int, robust: bool) -> int:
    """One pair-trip of the fused iteration at an h x w level: read I1 and I2
    (C planes each), the 3x3 motion and lambda, write the [K, 8, 8]
    moments. The template's gradients and their products are not counted:
    a kernel may form them from I1."""
    k = 5 if robust else 2
    return 2 * c * h * w * 4 + 9 * 4 + 4 + k * 64 * 4


def warp_bytes(c: int, h: int, w: int) -> int:
    """One pair of the final warp: read I2 (C planes), write Iw (C planes)
    and the one-byte valid mask. The sampling coordinates are not counted:
    a kernel may form them from the motion."""
    return 2 * c * h * w * 4 + h * w
