"""Stage-level device profile of the alignment pipeline on a CUDA card.

Times every pipeline stage, and the kernels K1 and K3, with CUDA events
(eval/benchmarks.py::cuda_event_ms, after a warm-up call) on the bench
workload's realistic motions (+-3 px, +-2/L homographies), warped at the
ground truth: the solver's hot state. Ends with K1's achieved HBM rate
against the card's peak (`hbm_peak_gbs`; none is assumed for an unknown
card).

The JAX profile's second `ic_solve` row (the XLA path beside the Pallas
one) has no counterpart: here the device of the data picks the path, and
on CUDA that is always the kernels. Needs a CUDA device; raises without.

Run:  python -m inverse_compositional_algorithm_tpu_torch.eval.profile_stages [--large]
"""

from __future__ import annotations

import sys

import torch

from ..models.ic import _masked_residual, ic_solve
from ..ops.kernels.fused_iter import fused_iter_moments, plan_fused_iter
from ..ops.kernels.normal_eq import fused_normal_eq
from ..ops.kernels.warp import warp_image_fast, warp_planar
from ..ops.normal_equations import RobustLoss, residual_moments, robust_weights
from ..ops.pyramid import build_pyramid
from ..ops.transforms import TransformType, transform_grid
from ..ops.warp import bicubic_sample, domain_mask
from .benchmarks import (
    require_cuda,
    cuda_event_ms,
    fused_iter_bytes_per_pair,
    hbm_peak_gbs,
    hot_state,
)

__all__ = ["profile_stages", "profile_large_frame"]


def _adder(results: dict, repeats: int):
    def add(name, fn, k=repeats):
        ms, _ = cuda_event_ms(fn, repeats=k, nsamples=1)
        results[name] = ms
        print(f"{name:46s} {ms:9.3f} ms", flush=True)
    return add


def profile_stages(batch: int = 16, height: int = 388, width: int = 584,
                   ttype: TransformType = TransformType.HOMOGRAPHY,
                   robust: RobustLoss = RobustLoss.CHARBONNIER,
                   repeats: int = 10) -> dict:
    """Measure each stage; returns {stage: ms} (plus K1's GB/s and share of
    the HBM peak) and prints a table."""
    require_cuda("profile_stages")
    i1, i2, p0, gx, gy, ix, iy, (gxx, gxy, gyy) = hot_state(batch, height, width, ttype)
    plan = plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust=True)
    plan_q = plan_fused_iter(i1, i2, ix, iy, gxx, gxy, gyy, robust=False)
    lam = torch.full((batch,), 5.0, device=i1.device)
    results: dict = {}
    add = _adder(results, repeats)

    add("transform_grid", lambda: transform_grid(p0, ttype, height, width))
    add("warp_planar (K3)", lambda: warp_planar(plan.i2p, gx, gy))
    add("warp_image_fast (K3 + domain mask)",
        lambda: warp_image_fast(i2, plan.i2p, gx, gy, 10))
    add("fused_iter_moments (K1, robust)",
        lambda: fused_iter_moments(plan.i2p, plan.tplp, gx, gy, lam, height, width,
                                   robust, True, 10))
    add("fused_iter_moments (K1, quadratic)",
        lambda: fused_iter_moments(plan_q.i2p, plan_q.tplp, gx, gy, lam, height, width,
                                   None, True, 10))
    add("bicubic_sample (plain gather)", lambda: bicubic_sample(i2, gx, gy), k=3)

    iw = bicubic_sample(i2, gx, gy)
    valid = domain_mask(gx, gy, height, width, 10)

    def chain():
        di = _masked_residual(iw, valid, i1, True)
        rho = robust_weights(di, lam[:, None, None], robust)
        u, v = residual_moments(ix, iy, di)
        return fused_normal_eq(rho * gxx, rho * gxy, rho * gyy, rho * u, rho * v,
                               ttype=ttype)

    add("residual+rho+moments+normal_eq (ops, K4)", chain)
    add("build_pyramid (5 scales, ipol)", lambda: build_pyramid(i1, 5, 0.5, "ipol"), k=4)
    add("ic_solve finest (robust, K1)",
        lambda: ic_solve(i1, i2, torch.zeros_like(p0), ttype, robust=robust), k=3)

    nbytes = batch * fused_iter_bytes_per_pair(i1.shape[-1], height, width)
    gbs = nbytes / (results["fused_iter_moments (K1, robust)"] * 1e-3) / 1e9
    peak, src = hbm_peak_gbs()
    share = None if peak is None else 100.0 * gbs / peak
    print(f"\nfused iter HBM traffic {nbytes / 1e6:.1f} MB/batch -> {gbs:.0f} GB/s "
          + (f"({share:.1f}% of {peak:.0f} GB/s, {src})" if peak else f"({src})"),
          flush=True)
    results["fused_iter_gbs"] = gbs
    results["pct_hbm_peak"] = share
    return results


def profile_large_frame(batch: int = 4, height: int = 720, width: int = 1280,
                        repeats: int = 10) -> dict:
    """K1 and K3 at 720p: one kernel serves every frame size (there is no
    VMEM stream mode to report)."""
    require_cuda("profile_large_frame")
    ttype = TransformType.HOMOGRAPHY
    i1, i2, _, gx, gy, ix, iy, g = hot_state(batch, height, width, ttype)
    plan = plan_fused_iter(i1, i2, ix, iy, *g, robust=True)
    lam = torch.full((batch,), 5.0, device=i1.device)
    results: dict = {}
    add = _adder(results, repeats)
    add(f"fused_iter_moments (K1, {width}x{height})",
        lambda: fused_iter_moments(plan.i2p, plan.tplp, gx, gy, lam, height, width,
                                   RobustLoss.CHARBONNIER, True, 10))
    add(f"warp_planar (K3, {width}x{height})", lambda: warp_planar(plan.i2p, gx, gy))
    return results


if __name__ == "__main__":
    if "--large" in sys.argv:
        profile_large_frame()
    else:
        profile_stages()
