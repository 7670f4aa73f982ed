"""Coarse-to-fine pyramidal solver.

Builds the image pyramids, runs the IC solver per scale from coarsest to
finest and rescales the parameters between levels (reference
src/inverse_compositional_algorithm.py:264-374). The warm start p0 is
propagated down to the coarsest level (the reference ignores a user p0 when
nscales > 1; identical for the default p0 = 0).
"""

from __future__ import annotations

import torch

from .. import constants as cts
from ..ops.normal_equations import RobustLoss
from ..ops.pyramid import build_pyramid, pyramid_shapes
from ..ops.transforms import TransformType, pad_params, zoom_in_params
from ..utils.profiling import span
from .ic import ic_solve

__all__ = ["pyramidal_solve"]


def pyramidal_solve(
    i1: torch.Tensor,
    i2: torch.Tensor,
    p0: torch.Tensor,
    ttype: TransformType,
    *,
    nscales: int = 5,
    nu: float = 0.5,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    pyramid_method: str = "ipol",
    precondition: bool = True,
    hessian_chunk: int = 16384,
    verbose: bool = False,
    collect_trace: bool = False,
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Full multi-scale alignment of batched pairs.

    Args:
      i1, i2: [B, H, W, C]; p0: [B, k<=8] warm start at the finest scale, on
      the images' device. Other args as in `ic_solve`.

    Returns:
      (state, per_scale): the finest scale's ICState and the per-scale
      ICStates coarsest-first; with collect_trace, also the per-scale traces
      coarsest-first.
    """
    def solve(l1, l2, p):
        return ic_solve(l1, l2, p, ttype, tol=tol, max_iter=max_iter, robust=robust, lam=lam,
                        nanifoutside=nanifoutside, delta=delta, precondition=precondition,
                        hessian_chunk=hessian_chunk, verbose=verbose,
                        collect_trace=collect_trace, divergence_guard=divergence_guard,
                        delta_cap=delta_cap)

    return _coarse_to_fine(i1, i2, p0, ttype, nscales, nu, pyramid_method, solve, collect_trace)


def _coarse_to_fine(i1, i2, p0, ttype: TransformType, nscales: int, nu: float,
                    pyramid_method: str, solve, collect_trace: bool = False):
    """`pyramidal_solve`'s loop with each level solved by `solve(i1_s, i2_s,
    p) -> state` (or (state, trace) with collect_trace), from the coarsest
    level to the finest; the row-tiled solver (`parallel.tiled`) passes its
    own per-level solve."""
    _, hh, ww, _ = i1.shape
    shapes = pyramid_shapes(hh, ww, nscales, nu)
    with span("ica.pyramid"):
        p1 = build_pyramid(i1, nscales, nu, pyramid_method)
        p2 = build_pyramid(i2, nscales, nu, pyramid_method)

    p = pad_params(p0.to(i1.dtype))
    for s in range(1, nscales):
        (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
        p = zoom_in_params(p, ttype, fw, fh, cw, ch)

    per_scale, traces = [], []
    state = None
    for s in range(nscales - 1, -1, -1):
        with span("ica.level"):
            state = solve(p1[s], p2[s], p)
        if collect_trace:
            state, trace = state
            traces.append(trace)
        per_scale.append(state)
        if s > 0:
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            p = zoom_in_params(state.p, ttype, cw, ch, fw, fh)
    if collect_trace:
        return state, per_scale, traces
    return state, per_scale
